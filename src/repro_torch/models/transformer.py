"""Decoder-only transformer LM, dense family (granite / minicpm / glm4 /
phi4): the serving half of the reference's ``models/transformer.py``.

Functional, like the reference: ``DecoderLM`` holds the configuration, the
options and the device; parameters and caches are explicit dictionaries of
tensors.  Layers are a Python list walked by a Python loop (the reference
stacks them on a leading axis for ``lax.scan``).  KV caches and page pools are
updated in place and returned.  ``forward``/``loss`` belong to the training
slice (ROADMAP queue A, item 2).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

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
    casts at every use); norm scales are always fp32."""

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

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
        if cfg.family != "dense" or cfg.is_moe:
            raise NotImplementedError(
                f"{cfg.name}: only the dense family is ported so far (MoE: ROADMAP queue A "
                "item 3; VLM: item 2, its patch prefix lives in `forward`)"
            )
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
                    "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype=pdt),
                }
                for _ in range(cfg.n_layers)
            ],
            "final_norm": L.init_rmsnorm(cfg.d_model, self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(generator, (cfg.d_model, cfg.padded_vocab), dtype=pdt)
        return params

    # --------------------------------------------------------------- pieces
    def embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"]["tokens"].to(self.opts.cdt)[tokens.long()]

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg, cdt = self.cfg, self.opts.cdt
        head = params["embed"]["tokens"].T if cfg.tie_embeddings else params["lm_head"]
        out = x @ head.to(cdt)
        if cfg.padded_vocab != cfg.vocab:
            # mask padding entries so argmax / softmax ignore them
            valid = torch.arange(cfg.padded_vocab, device=out.device) < cfg.vocab
            out = torch.where(valid, out, L.MASK_VALUE)
        return out

    def _layer_stack(self, params: dict, x: torch.Tensor, attn_fn, caches: dict):
        """The reference's ``_paged_layer_stack`` (and the scan of its
        ``decode_step``): walk the layers, threading layer i's slice of every
        cache tensor through ``attn_fn(attn_params, normed_x, layer_cache) ->
        (h, cache)``; the slices are views, so the caches are updated in place."""
        cfg = self.cfg
        for i, lp in enumerate(params["layers"]):
            layer_cache = {name: t[i] for name, t in caches.items()}
            h, _ = attn_fn(lp["attn"], L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps), layer_cache)
            x = x + h
            x = x + L.mlp_fwd(lp["mlp"], L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps))
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
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
        caller samples from position ``length - 1``."""
        x = self.embed(params, tokens)
        attn = lambda ap, normed, pg: L.attention_prefill_paged(
            ap, normed, pg, block_table, length, **self._attn_kwargs())
        return self._layer_stack(params, x, attn, pages), pages
