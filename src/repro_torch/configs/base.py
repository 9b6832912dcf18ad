"""Architecture configuration schema + input-shape registry (the port's
own copy of the reference's ``configs/base.py``; pure data, no framework).

Every assigned architecture gets one ``src/repro_torch/configs/<id>.py`` exporting
``CONFIG`` (the exact published hyper-parameters) built on :class:`ArchConfig`.
``reduced()`` derives the CPU-smoke variant (same family/topology, tiny
widths).  The input-shape set is shared by all LM-family archs:

    train_4k     seq 4096  x global batch 256   (train_step)
    prefill_32k  seq 32768 x global batch 32    (serve prefill)
    decode_32k   seq 32768 KV x global batch 128 (serve_step, 1 new token)
    long_500k    seq 524288 KV x global batch 1  (serve_step; sub-quadratic
                                                  archs only -- see DESIGN.md)
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture; covers dense / MoE / VLM / SSM / audio / hybrid."""

    name: str
    family: str               # dense | moe | vlm | ssm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0         # per-expert FFN hidden (0 -> use d_ff)
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0        # mamba2 heads (0 -> derived)
    ssm_expand: int = 2
    attn_every: int = 0       # hybrid: shared attention every k blocks
    slstm_every: int = 0      # xlstm: one sLSTM per k-block repeating unit
    long_context_window: int = 0  # sliding-window cap for hybrid attention

    # audio (enc-dec)
    n_encoder_layers: int = 0

    # common
    head_dim: int = 0         # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # modality frontends are STUBS: input_specs() provides precomputed
    # patch/frame embeddings (see DESIGN.md §4)
    n_patches: int = 0        # vlm: visual prefix length

    # schedule hint (minicpm uses WSD)
    lr_schedule: str = "cosine"

    notes: str = ""

    def __post_init__(self):
        if self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads must be divisible by n_kv_heads")

    # ------------------------------------------------------------ derived
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the vocab-parallel axis
        divides any power-of-two TP degree (an unpadded 122753-entry table
        would replicate the (b,s,V) logits on the model axis)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_ff(self) -> int:
        return self.d_expert or self.d_ff

    @property
    def supports_decode(self) -> bool:
        return True  # all assigned archs are (or contain) decoders

    @property
    def supports_long_context(self) -> bool:
        # long_500k runs only for archs whose per-token decode state is O(1)
        # or window-bounded in sequence length (SSM / hybrid).
        return self.family in ("ssm", "hybrid")

    def shapes(self) -> list[ShapeSpec]:
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
        if self.supports_long_context:
            out.append(SHAPES["long_500k"])
        return out

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS in roofline)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.is_moe:
            ffn = 3 * d * self.expert_ff * self.n_experts + d * self.n_experts  # + router
        elif self.d_ff:
            ffn = 3 * d * self.d_ff
        else:
            ffn = 0
        per_layer = attn + ffn + 2 * d
        if self.family == "ssm":
            d_in = self.ssm_expand * d
            per_layer = 2 * d * d_in + d_in * d + 4 * d  # qkv-ish proj + gates
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            per_layer = d * (2 * d_in + 2 * self.ssm_state * 2) + d_in * d
        total = emb + self.n_layers * per_layer
        if self.family == "audio":
            total += self.n_encoder_layers * per_layer
        if self.family == "hybrid" and self.attn_every:
            total += 4 * (2 * d) * (2 * d)  # shared attention block (2d wide)
        return int(total)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - 3 * d * self.expert_ff * self.n_experts * self.n_layers
        return int(dense + 3 * d * self.expert_ff * self.top_k * self.n_layers)

    # ------------------------------------------------------------- reduced
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        scale = {
            "d_model": 64,
            "n_layers": max(2, min(4, self.n_layers)),
            "n_heads": 4,
            "n_kv_heads": max(1, min(4, self.n_kv_heads if self.n_kv_heads < self.n_heads else 4)),
            "d_ff": 128 if self.d_ff else 0,
            "vocab": 512,
            "head_dim": 16,
        }
        if self.is_moe:
            scale.update(n_experts=4, top_k=min(2, self.top_k), d_expert=64)
        if self.ssm_state:
            scale.update(ssm_state=16, ssm_heads=4)
        if self.attn_every:
            scale.update(attn_every=2)
        if self.slstm_every:
            scale.update(slstm_every=2)
        if self.n_encoder_layers:
            scale.update(n_encoder_layers=2)
        if self.n_patches:
            scale.update(n_patches=16)
        if self.long_context_window:
            scale.update(long_context_window=64)
        return dataclasses.replace(self, **scale)
