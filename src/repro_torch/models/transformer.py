"""Decoder-only transformer LM: dense (granite / minicpm / glm4 / phi4), MoE
(dbrx / qwen3-moe) and VLM (phi-3-vision: the backbone behind a projected
prefix of precomputed patch embeddings), the reference's
``models/transformer.py`` for training (``forward``, ``loss``) and serving.

Functional, like the reference: ``DecoderLM`` holds the configuration, the
options and the device; parameters and caches are explicit dictionaries of
tensors.  Layers are a Python list walked by a Python loop (the reference
stacks them on a leading axis for ``lax.scan``), each under
``torch.utils.checkpoint`` when ``remat`` is on and autograd is recording (the
reference's per-layer ``jax.checkpoint``).  KV caches and page pools are
updated in place and returned.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import lshard

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises when a CUDA device is asked
    for on a machine that has none (no silent fall-back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return device


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Dtypes of the weights and of the activations.  For serving the weights
    are held once, in the compute dtype (the reference keeps fp32 masters and
    casts at every use); training passes ``param_dtype="float32"``, the
    reference's masters.  Norm scales and MoE routers are always fp32.
    ``remat``: recompute each layer's activations in the backward (the
    reference's ``"full"`` policy; its ``"save_tp_outputs"`` waits for the
    parallelism layer).  ``moe_capacity_factor``: 0 takes the config's."""

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    moe_capacity_factor: float = 0.0

    @property
    def pdt(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdt(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


class DecoderLM:
    """Functional LM; all state in explicit parameter / cache dictionaries."""

    def __init__(self, cfg: ArchConfig, opts: ModelOptions | None = None,
                 device: torch.device | str = "cuda"):
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"DecoderLM does not serve family {cfg.family!r}")
        self.cfg = cfg
        self.opts = opts or ModelOptions()
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn on ``generator``'s device, which must be the
        model's: weights go straight to the device in ``param_dtype``."""
        cfg, pdt = self.cfg, self.opts.pdt
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        hd = cfg.resolved_head_dim
        params = {
            "embed": {"tokens": L.dense_init(generator, (cfg.padded_vocab, cfg.d_model), dtype=pdt)},
            "layers": [
                {
                    "attn": L.init_attention(generator, cfg.d_model, cfg.n_heads,
                                             cfg.n_kv_heads, hd, dtype=pdt),
                    "attn_norm": L.init_rmsnorm(cfg.d_model, self.device),
                    "ffn_norm": L.init_rmsnorm(cfg.d_model, self.device),
                    **({"moe": L.init_moe(generator, cfg.d_model, cfg.n_experts, cfg.expert_ff,
                                          dtype=pdt)} if cfg.is_moe else
                       {"mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype=pdt)}),
                }
                for _ in range(cfg.n_layers)
            ],
            "final_norm": L.init_rmsnorm(cfg.d_model, self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.padded_vocab), dtype=pdt)
        if cfg.family == "vlm":
            # the modality frontend is a stub: one adapter projecting precomputed
            # patch embeddings into the backbone's space
            params["patch_proj"] = L.dense_init(generator, (cfg.d_model, cfg.d_model), dtype=pdt)
        return params

    # --------------------------------------------------------------- pieces
    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding: its CUDA backward sums a row's gradients in a fixed order
        x = F.embedding(tokens.long(), params["embed"]["tokens"].to(self.opts.cdt))
        return lshard(x, "batch", "seq", "embed")

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg, cdt = self.cfg, self.opts.cdt
        head = params["embed"]["tokens"].T if cfg.tie_embeddings else params["lm_head"]
        out = x @ head.to(cdt)
        if cfg.padded_vocab != cfg.vocab:
            # mask padding entries so argmax / softmax ignore them
            valid = torch.arange(cfg.padded_vocab, device=out.device) < cfg.vocab
            out = torch.where(valid, out, L.MASK_VALUE)
        return lshard(out, "batch", "seq", "vocab")

    # -------------------------------------------------------------- forward
    def _layer(self, lp: dict, x: torch.Tensor, attn, return_aux: bool = False):
        """One pre-norm block; ``attn(attn_params, normed_x) -> h``.  Returns
        (x, the MoE's aux loss where ``return_aux`` and the family has one,
        else None)."""
        cfg = self.cfg
        x = x + attn(lp["attn"], L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps))
        x = lshard(x, "batch", "seq_sp", "embed")
        normed = L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
        if not cfg.is_moe:
            return lshard(x + L.mlp_fwd(lp["mlp"], normed), "batch", "seq_sp", "embed"), None
        out = L.moe_fwd(lp["moe"], normed, top_k=cfg.top_k,
                        capacity_factor=self.opts.moe_capacity_factor or cfg.capacity_factor,
                        return_aux=return_aux)
        h, aux = out if return_aux else (out, None)
        return lshard(x + h, "batch", "seq_sp", "embed"), aux

    def forward(self, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """batch: {"tokens": (b, s) int [, "patches": (b, P, d)]} -> (logits
        (b, s, V), the MoE aux loss summed over the layers in fp32: a zero
        scalar for the other families).  A VLM's projected patches go before
        the tokens; positions and the causal mask run over the whole
        sequence, and only the token positions are scored."""
        cfg = self.cfg
        x = self.embed(params, batch["tokens"])
        if cfg.family == "vlm":
            cdt = self.opts.cdt
            prefix = batch["patches"].to(cdt) @ params["patch_proj"].to(cdt)
            x = lshard(torch.cat([prefix, x], dim=1), "batch", "seq", "embed")
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        attn = lambda ap, normed: L.attention_fwd(ap, normed, positions, causal=True,
                                                  **self._attn_kwargs())
        remat = self.opts.remat and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in params["layers"]:
            if remat:
                # a layer draws no random numbers: no RNG state to keep
                x, layer_aux = checkpoint(self._layer, lp, x, attn, True, use_reentrant=False,
                                          preserve_rng_state=False)
            else:
                x, layer_aux = self._layer(lp, x, attn, True)
            if layer_aux is not None:
                aux = aux + layer_aux.float()
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        if cfg.family == "vlm":
            x = x[:, cfg.n_patches:]   # score only the token positions
        return self.logits(params, x), aux

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy in fp32 over the padded vocab (the padding
        masked in ``logits``); labels < 0 are not scored.  Returns (ce + 0.01
        aux, {"ce", "aux", "tokens"}), as the reference's."""
        logits, aux = self.forward(params, batch)
        ce, denom = L.cross_entropy(logits, batch["labels"])
        return ce + 0.01 * aux, {"ce": ce, "aux": aux, "tokens": denom}

    def _layer_stack(self, params: dict, x: torch.Tensor, attn_fn, caches: dict):
        """The reference's ``_paged_layer_stack`` (and the scan of its
        ``decode_step``): walk the layers, threading layer i's slice of every
        cache tensor through ``attn_fn(attn_params, normed_x, layer_cache) ->
        (h, cache)``; the slices are views, so the caches are updated in place."""
        for i, lp in enumerate(params["layers"]):
            layer_cache = {name: t[i] for name, t in caches.items()}
            x, _ = self._layer(lp, x, lambda ap, normed: attn_fn(ap, normed, layer_cache)[0])
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        return self.logits(params, x)

    def _attn_kwargs(self) -> dict:
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta)

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int) -> dict:
        """Dense KV cache: {"kv": {"k","v"}: (n_layers, b, L, K, hd), "index"}."""
        cfg = self.cfg
        kv = L.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim,
                             dtype=self.opts.cdt, device=self.device)
        return {
            "kv": {n: t.new_zeros((cfg.n_layers, *t.shape)) for n, t in kv.items()},
            "index": 0,
        }

    def cache_axes(self) -> dict:
        """Logical axis names of every leaf of ``init_cache``'s tree (they
        drive ``train_step.cache_shardings``)."""
        kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        return {"kv": {"k": kv, "v": kv}, "index": ()}

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """One-token decode: tokens (b, 1) -> (logits (b, 1, V), cache)."""
        x = self.embed(params, tokens)
        index = cache["index"]
        attn = lambda ap, normed, kvc: L.attention_decode(
            ap, normed, kvc, index, **self._attn_kwargs())
        logits = self._layer_stack(params, x, attn, cache["kv"])
        return logits, {"kv": cache["kv"], "index": index + 1}

    # ---------------------------------------------------------- paged serve
    def init_paged_cache(self, n_pages: int, page_size: int) -> dict:
        """Per-layer paged KV pool: {"k","v"} of shape (n_layers, n_pages + 1,
        page_size, K, hd); the last page of every layer is the spare that takes
        dropped writes.  Page bookkeeping lives in
        :class:`repro_torch.serve.kv_cache.PagedKVCache`."""
        cfg = self.cfg
        kv = L.init_paged_kv(n_pages, page_size, cfg.n_kv_heads, cfg.resolved_head_dim,
                             dtype=self.opts.cdt, device=self.device)
        return {n: t.new_zeros((cfg.n_layers, *t.shape)) for n, t in kv.items()}

    def decode_step_paged(self, params: dict, pages: dict, block_tables: torch.Tensor,
                          lengths: torch.Tensor, tokens: torch.Tensor, active: torch.Tensor
                          ) -> tuple[torch.Tensor, dict]:
        """Continuous-batching decode: one token per lane against the paged
        cache.  ``tokens`` (b, 1); ``block_tables`` (b, max_blocks);
        ``lengths``/``active`` (b,).  Returns (logits (b, 1, V), pages)."""
        x = self.embed(params, tokens)
        attn = lambda ap, normed, pg: L.attention_decode_paged(
            ap, normed, pg, block_tables, lengths, active, **self._attn_kwargs())
        return self._layer_stack(params, x, attn, pages), pages

    def prefill_paged(self, params: dict, pages: dict, block_table: torch.Tensor,
                      length: int, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """Prefill one sequence (tokens (1, S) padded, true length ``length``),
        scattering its KV into pages.  Returns (logits (1, S, V), pages); the
        caller samples from position ``length - 1``.  A VLM serves text only,
        as the reference's (no patches here)."""
        x = self.embed(params, tokens)
        attn = lambda ap, normed, pg: L.attention_prefill_paged(
            ap, normed, pg, block_table, length, **self._attn_kwargs())
        return self._layer_stack(params, x, attn, pages), pages
