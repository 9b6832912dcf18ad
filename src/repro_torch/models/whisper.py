"""Whisper-style encoder-decoder ASR backbone (arXiv:2212.04356).  PyTorch
counterpart of the reference's ``models/whisper.py``: training (``forward``,
``loss``) and serving (``init_cache`` -> ``prefill_cross`` -> ``decode_step``).

The conv/mel frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings (b, n_frames, d_model) and one linear adapter
("frame_proj") stands in for the conv stack.  Positions are sinusoidal for
both stacks, MLPs are 2-layer GELU (the tanh form, as ``jax.nn.gelu``'s
default), the output head is tied to the token embedding.

The encoder's self-attention (non-causal), the decoder's self-attention
(causal) and its cross-attention over the encoder's output (non-causal, more
keys than queries) all go through ``layers.attention_fwd`` and so through the
flash-attention kernel; RMSNorm through ``ops.rmsnorm``.  Decode attends the
cached encoder K/V with plain ``layers.attention_scores``, as the reference.

As in ``models/transformer.py``: parameters and caches are explicit
dictionaries, the layers of each stack a Python list (the reference stacks them
``(n, ...)``), under ``remat`` each layer runs under ``torch.utils.checkpoint``
while autograd records, and caches are updated in place and returned.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import ModelOptions, init_on_meta, resolve_device
from repro_torch.models.xlstm import _mask_padded_vocab
from repro_torch.parallel.sharding import gather_at_use, lshard

N_FRAMES = 1500  # whisper's 30 s window after the conv stack


def sinusoid_pos(seq_len: int, d_model: int, offset: int = 0,
                 device: torch.device | str = "cpu") -> torch.Tensor:
    """(seq_len, d_model) fp32: sin on the even columns, cos on the odd ones,
    at angle ``pos / 10000^(dim / d_model)``."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None] + offset
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d_model)
    return torch.stack([ang.sin(), ang.cos()], dim=-1).reshape(seq_len, d_model)


def init_gelu_mlp(generator: torch.Generator, d_model: int, d_ff: int,
                  dtype: torch.dtype) -> dict:
    return {"mlp": {"w_in": L.dense_init(generator, (d_model, d_ff), dtype=dtype),
                    "w_out": L.dense_init(generator, (d_ff, d_model), dtype=dtype)}}


def gelu_mlp_fwd(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU in fp32 between two products in the compute dtype."""
    cd = x.dtype
    h = x @ p["mlp"]["w_in"].to(cd)
    h = F.gelu(h.float(), approximate="tanh").to(cd)
    return h @ p["mlp"]["w_out"].to(cd)


class WhisperLM:
    """Encoder (``n_encoder_layers``) and decoder (``n_layers``) stacks; all
    state in explicit parameter / cache dictionaries."""

    def __init__(self, cfg: ArchConfig, opts: ModelOptions | None = None,
                 device: torch.device | str = "cuda"):
        if cfg.family != "audio":
            raise ValueError(f"{cfg.name}: WhisperLM takes the audio family, not {cfg.family!r}")
        self.cfg = cfg
        self.opts = opts or ModelOptions()
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def _init_attn(self, generator: torch.Generator) -> dict:
        cfg = self.cfg
        return L.init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, dtype=self.opts.pdt)

    @init_on_meta
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn on ``generator``'s device, which must be the
        model's: weights go straight to the device in ``param_dtype``.  On
        ``meta``: the tree drawn from nothing (``transformer.init_on_meta``)."""
        cfg, pdt, dev = self.cfg, self.opts.pdt, self.device
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on {dev}")
        norm = lambda: L.init_rmsnorm(cfg.d_model, dev)   # noqa: E731
        return {
            "embed": {"tokens": L.dense_init(generator, (cfg.padded_vocab, cfg.d_model), dtype=pdt)},
            "frame_proj": L.dense_init(generator, (cfg.d_model, cfg.d_model), dtype=pdt),
            "enc_layers": [{"attn": self._init_attn(generator), "attn_norm": norm(),
                            "ffn_norm": norm(),
                            **init_gelu_mlp(generator, cfg.d_model, cfg.d_ff, pdt)}
                           for _ in range(cfg.n_encoder_layers)],
            "dec_layers": [{"attn": self._init_attn(generator), "attn_norm": norm(),
                            "xattn": self._init_attn(generator), "xattn_norm": norm(),
                            "ffn_norm": norm(),
                            **init_gelu_mlp(generator, cfg.d_model, cfg.d_ff, pdt)}
                           for _ in range(cfg.n_layers)],
            "enc_norm": norm(),
            "final_norm": norm(),
            # whisper ties the output head to the token embedding
        }

    def _attn_kwargs(self) -> dict:
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim, use_rope=False)

    def _stack(self, body, layers: list[dict], x: torch.Tensor, *args) -> torch.Tensor:
        remat = self.opts.remat and torch.is_grad_enabled()
        for lp in layers:
            if remat:
                # a layer draws no random numbers: no RNG state to keep
                x = checkpoint(body, lp, x, *args, use_reentrant=False, preserve_rng_state=False)
            else:
                x = body(lp, x, *args)
        return x

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(gather_at_use(params["final_norm"]), x, self.cfg.norm_eps)
        head = gather_at_use(params["embed"]["tokens"]).T
        logits = _mask_padded_vocab(x @ head.to(self.opts.cdt), self.cfg)
        return lshard(logits, "batch", "seq", "vocab")

    def _embed(self, params: dict, tokens: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """Token embeddings plus the sinusoid positions from ``offset``.  Laid
        out at once: a vocab-sharded table's lookup is a masked partial sum,
        which DTensor can reduce only once."""
        cfg, cd = self.cfg, self.opts.cdt
        x = lshard(F.embedding(tokens.long(), gather_at_use(params["embed"]["tokens"]).to(cd)),
                   "batch", "seq", "embed")
        return x + sinusoid_pos(tokens.shape[1], cfg.d_model, offset=offset,
                                device=x.device).to(cd)[None]

    # --------------------------------------------------------------- encoder
    def _enc_layer(self, lp: dict, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        eps = self.cfg.norm_eps
        lp = gather_at_use(lp)   # inside the checkpoint: the recompute gathers again
        x = x + L.attention_fwd(lp["attn"], L.rmsnorm(lp["attn_norm"], x, eps), positions,
                                causal=False, **self._attn_kwargs())
        return x + gelu_mlp_fwd(lp, L.rmsnorm(lp["ffn_norm"], x, eps))

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """frames (b, n_frames, d_model) -> the encoder's output, normed."""
        cfg, cd = self.cfg, self.opts.cdt
        x = frames.to(cd) @ gather_at_use(params["frame_proj"]).to(cd)
        x = x + sinusoid_pos(x.shape[1], cfg.d_model, device=x.device).to(cd)[None]
        x = lshard(x, "batch", "seq", "embed")
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = self._stack(self._enc_layer, params["enc_layers"], x, positions)
        return L.rmsnorm(gather_at_use(params["enc_norm"]), x, cfg.norm_eps)

    # --------------------------------------------------------------- decoder
    def _cross_kv(self, lp: dict, enc_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The cross-attention's K/V projected from the encoder's output:
        each (b, n_frames, K, hd), contiguous."""
        cfg, cd = self.cfg, self.opts.cdt
        K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        lp = gather_at_use(lp)
        return (L._split_heads(enc_out @ lp["xattn"]["wk"].to(cd), K, hd),
                L._split_heads(enc_out @ lp["xattn"]["wv"].to(cd), K, hd))

    def _dec_layer(self, lp: dict, x: torch.Tensor, positions: torch.Tensor,
                   enc_out: torch.Tensor) -> torch.Tensor:
        eps = self.cfg.norm_eps
        lp = gather_at_use(lp)   # inside the checkpoint: the recompute gathers again
        x = x + L.attention_fwd(lp["attn"], L.rmsnorm(lp["attn_norm"], x, eps), positions,
                                causal=True, **self._attn_kwargs())
        x = x + L.attention_fwd(lp["xattn"], L.rmsnorm(lp["xattn_norm"], x, eps), positions,
                                causal=False, kv_override=self._cross_kv(lp, enc_out),
                                **self._attn_kwargs())
        return x + gelu_mlp_fwd(lp, L.rmsnorm(lp["ffn_norm"], x, eps))

    def decode_stack(self, params: dict, tokens: torch.Tensor, enc_out: torch.Tensor
                     ) -> torch.Tensor:
        """tokens (b, s) over the encoder's output -> logits (b, s, padded_vocab)."""
        x = self._embed(params, tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = self._stack(self._dec_layer, params["dec_layers"], x, positions, enc_out)
        return self._logits(params, x)

    def forward(self, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """batch: {"tokens": (b, s), "frames": (b, n_frames, d)} -> (logits
        (b, s, padded_vocab), aux: a zero fp32 scalar, as the reference's)."""
        logits = self.decode_stack(params, batch["tokens"], self.encode(params, batch["frames"]))
        return logits, torch.zeros((), dtype=torch.float32, device=logits.device)

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """``layers.cross_entropy`` of the logits: (ce, {"ce", "aux",
        "tokens"}), as the reference's."""
        logits, aux = self.forward(params, batch)
        ce, denom = L.cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce, "aux": aux, "tokens": denom}

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, n_frames: int = N_FRAMES) -> dict:
        """{"kv": {"k","v"}: (n_layers, b, max_len, K, hd), "cross_k",
        "cross_v": (n_layers, b, n_frames, K, hd), "index"}, in the compute
        dtype."""
        cfg, cd = self.cfg, self.opts.cdt
        hd, K, nl = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_layers
        kv = L.init_kv_cache(batch, max_len, K, hd, dtype=cd, device=self.device)
        cross = torch.zeros((nl, batch, n_frames, K, hd), dtype=cd, device=self.device)
        return {"kv": {n: t.new_zeros((nl, *t.shape)) for n, t in kv.items()},
                "cross_k": cross, "cross_v": cross.clone(), "index": 0}

    def cache_axes(self) -> dict:
        """Logical axis names of every leaf of ``init_cache``'s tree."""
        kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        cross = ("layers", "batch", None, "kv_heads", "head_dim")
        return {"kv": {"k": kv, "v": kv}, "cross_k": cross, "cross_v": cross, "index": ()}

    def prefill_cross(self, params: dict, cache: dict, frames: torch.Tensor) -> dict:
        """Run the encoder once and put each decoder layer's cross-attention
        K/V in the cache.  The cross tensors are replaced, not copied into:
        they take the frame count of ``frames``, whatever ``init_cache`` sized."""
        enc_out = self.encode(params, frames)
        kv = [self._cross_kv(lp, enc_out) for lp in params["dec_layers"]]
        dt = cache["cross_k"].dtype
        return {**cache, "cross_k": torch.stack([k for k, _ in kv]).to(dt),
                "cross_v": torch.stack([v for _, v in kv]).to(dt)}

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """One-token decode: tokens (b, 1) -> (logits (b, 1, padded_vocab),
        cache with ``index + 1``); the self-attention KV is updated in place."""
        cfg, cd = self.cfg, self.opts.cdt
        eps, b = cfg.norm_eps, tokens.shape[0]
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        index = cache["index"]
        x = self._embed(params, tokens, offset=index)
        for i, lp in enumerate(params["dec_layers"]):
            lp = gather_at_use(lp)
            kvc = {n: t[i] for n, t in cache["kv"].items()}
            h, _ = L.attention_decode(lp["attn"], L.rmsnorm(lp["attn_norm"], x, eps), kvc, index,
                                      **self._attn_kwargs())
            x = x + h
            # cross attention over the (precomputed) encoder K/V, every frame
            xn = L.rmsnorm(lp["xattn_norm"], x, eps)
            q = L._split_heads(xn @ lp["xattn"]["wq"].to(cd), H, hd)
            ck, cv = cache["cross_k"][i].to(cd), cache["cross_v"][i].to(cd)
            mask = torch.ones((1, 1, 1, ck.shape[1]), dtype=torch.bool, device=x.device)
            h = L.attention_scores(q, ck, cv, mask, compute_dtype=cd).reshape(b, 1, H * hd)
            x = x + h @ lp["xattn"]["wo"].to(cd)
            x = x + gelu_mlp_fwd(lp, L.rmsnorm(lp["ffn_norm"], x, eps))
        return self._logits(params, x), {**cache, "index": index + 1}
