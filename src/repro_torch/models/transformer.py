"""Decoder-only transformer LM: dense (granite / minicpm / glm4 / phi4), MoE
(dbrx / qwen3-moe) and VLM (phi-3-vision: the backbone behind a projected
prefix of precomputed patch embeddings), the reference's
``models/transformer.py`` for training (``forward``, ``loss``) and serving.

Functional, like the reference: ``DecoderLM`` holds the configuration, the
options and the device; parameters and caches are explicit dictionaries of
tensors.  Layers are a Python list walked by a Python loop (the reference
stacks them on a leading axis for ``lax.scan``), each under
``torch.utils.checkpoint`` when ``remat`` is on and autograd is recording (the
reference's per-layer ``jax.checkpoint``), with the ``remat_policy`` of the
options.  On a mesh each layer gathers its ZeRO-3 weights inside that body
(``parallel.sharding.gather_at_use``), as the reference's scan body gathers
its layer's slice: a rank holds one layer's gathered weights at a time.  KV
caches and page pools are updated in place and returned.

``remat_policy="save_tp_outputs"`` is the reference's
``save_only_these_names("attn_out", "mlp_out")``, built on selective
checkpointing: :func:`tp_output` stands for ``checkpoint_name``.  It lays the
attention's and the MLP's (MoE's) output out for the residual stream -- on a
mesh, the tensor-parallel all-reduce of the row-parallel product -- and the
policy saves what comes out: the collective's result where there is one, else
a copy made by the identity op ``repro_torch::saved_output`` (the policy sees
ops, not names, and a custom op's output may not alias its input).  Every op
issued inside :func:`tp_output` is saved, so the recompute pass replays the
layer's math and no collective.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import threading

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import gather_at_use, lshard

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
REMAT_POLICIES = ("full", "save_tp_outputs")


@torch.library.custom_op("repro_torch::saved_output", mutates_args=())
def saved_output(x: torch.Tensor) -> torch.Tensor:
    """The identity, as a copy: the op the ``save_tp_outputs`` policy saves."""
    return x.clone()


@saved_output.register_fake
def _(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x)


saved_output.register_autograd(lambda ctx, grad: grad)


class _Tagging(threading.local):
    active = False


_TAGGING = _Tagging()


@contextlib.contextmanager
def _tagging():
    prev, _TAGGING.active = _TAGGING.active, True
    try:
        yield
    finally:
        _TAGGING.active = prev


def tp_output(x: torch.Tensor, *logical: str) -> torch.Tensor:
    """``x`` laid out at ``logical`` (``lshard``), every op of it tagged for
    the ``save_tp_outputs`` policy: the counterpart of the reference's
    ``checkpoint_name`` on a post-all-reduce tensor.  A DTensor that is a
    partial sum (a row-parallel product) is reduced here, and the collective's
    result is the saved tensor; any other tensor is copied by
    :func:`saved_output` (on a DTensor, its local shard)."""
    from torch.distributed.tensor import Partial

    with _tagging():
        if not ops.is_dtensor(x):
            return saved_output(x)
        reduced = any(isinstance(p, Partial) for p in x.placements)
        x = lshard(x, *logical)
        if reduced:
            return x
        return ops.on_shards(saved_output, x.device_mesh, [x], [x.placements], [x.placements])


def _save_tp_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if _TAGGING.active:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_tp_contexts():
    return create_selective_checkpoint_contexts(_save_tp_policy)


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


def init_on_meta(init):
    """Decorator of a model's ``init(generator)``: on a model built on the
    ``meta`` device it takes no generator and returns the tree ``init``
    builds -- the same paths, shapes and dtypes -- as meta tensors, drawing
    nothing (the counterpart of ``jax.eval_shape`` of the reference's
    ``init``).  ``init`` runs for a CPU twin of the model under
    ``FakeTensorMode``, so no storage is allocated either; each leaf becomes
    a meta tensor as it is made (``layers.made``), before any outer hook sees
    it."""
    @functools.wraps(init)
    def wrapper(self, generator: torch.Generator | None = None) -> dict:
        if self.device.type != "meta":
            return init(self, generator)
        from torch._subclasses.fake_tensor import FakeTensorMode

        twin = copy.copy(self)
        twin.device = torch.device("cpu")
        to_meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731
        with FakeTensorMode(), L.making(to_meta):
            tree = init(twin, torch.Generator())
        _check_made(tree, lambda t: t.device.type == "meta")
        return tree

    return wrapper


def _check_made(tree, ok) -> None:
    """Raise, naming them, on the leaves of ``tree`` for which ``ok`` is false:
    leaves an ``init`` made without ``layers.made``."""
    from repro_torch.parallel.sharding import map_with_path

    bad = []
    map_with_path(lambda path, t: None if ok(t) else bad.append(path), tree)
    if bad:
        raise RuntimeError(f"init made {', '.join(bad[:3])}{' and more' if len(bad) > 3 else ''} "
                           "without layers.made")


def init_laid_out(model, generator: torch.Generator | None, layouts) -> dict:
    """``model.init(generator)`` laid out as it is drawn: the same leaves from
    the same generator in the same order, each drawn whole on the model's
    device, replaced at once by this rank's local shard of it (a DTensor by
    ``layouts(template)``, a tree of ``parallel.sharding.NamedSharding`` for
    the tree ``init`` builds) and freed before the next is drawn.  Gathered,
    the tree is ``model.init(generator)`` bit for bit; a rank holds at most
    its shards and one whole leaf.  The template and the order the leaves are
    made in come from a first ``init`` under ``FakeTensorMode`` (of a CPU twin
    for a model on ``meta``), which allocates nothing and draws nothing from
    ``generator``.  Raises if a leaf is made outside
    ``layers.made``: it would be laid out whole."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.parallel import sharding as shd

    order: list = []
    record = lambda t: order.append(t) or t  # noqa: E731
    twin = model
    if model.device.type == "meta":   # its init would make meta leaves
        twin = copy.copy(model)
        twin.device = torch.device("cpu")
    with FakeTensorMode(), L.making(record):
        template = twin.init(torch.Generator(device=twin.device))
    paths: dict = {}
    shd.map_with_path(lambda path, t: paths.setdefault(id(t), path), template)
    if len(paths) != len(order) or any(id(t) not in paths for t in order):
        raise RuntimeError(f"{type(model).__name__}.init made {len(order)} leaves through "
                           f"layers.made for a tree of {len(paths)}")
    shardings: dict = {}
    shd.map_with_path(lambda path, s: shardings.setdefault(path, s), layouts(template))
    queue = [shardings[paths[id(t)]] for t in order]
    del order, template

    def place(t):
        if not queue:
            raise RuntimeError(f"{type(model).__name__}.init made more leaves than its template")
        return shd.distribute(t, queue.pop(0)).detach()

    with L.making(place):
        tree = model.init(generator)
    _check_made(tree, shd.is_dtensor)
    return tree


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Dtypes of the weights and of the activations.  For serving the weights
    are held once, in the compute dtype (the reference keeps fp32 masters and
    casts at every use); training passes ``param_dtype="float32"``, the
    reference's masters.  Norm scales and MoE routers are always fp32.
    ``remat``: recompute each layer's activations in the backward, under
    ``remat_policy``: ``"full"`` keeps only the layer's input,
    ``"save_tp_outputs"`` also its attention and MLP (MoE) outputs after the
    tensor-parallel all-reduce (:func:`tp_output`; read by ``DecoderLM`` only,
    as in the reference).  ``moe_capacity_factor``: 0 takes the config's."""

    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    moe_capacity_factor: float = 0.0
    remat_policy: str = "full"

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} is not one of {REMAT_POLICIES}")

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
    @init_on_meta
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn on ``generator``'s device, which must be the
        model's: weights go straight to the device in ``param_dtype``.  On
        ``meta``: the tree drawn from nothing (:func:`init_on_meta`)."""
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
        x = F.embedding(tokens.long(), gather_at_use(params["embed"]["tokens"]).to(self.opts.cdt))
        return lshard(x, "batch", "seq", "embed")

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        cfg, cdt = self.cfg, self.opts.cdt
        head = (gather_at_use(params["embed"]["tokens"]).T if cfg.tie_embeddings
                else gather_at_use(params["lm_head"]))
        out = x @ head.to(cdt)
        if cfg.padded_vocab != cfg.vocab:
            # mask padding entries so argmax / softmax ignore them
            valid = torch.arange(cfg.padded_vocab, device=out.device) < cfg.vocab
            out = torch.where(valid, out, L.MASK_VALUE)
        return lshard(out, "batch", "seq", "vocab")

    # -------------------------------------------------------------- forward
    def _layer(self, lp: dict, x: torch.Tensor, attn, return_aux: bool = False,
               tag: bool = False):
        """One pre-norm block; ``attn(attn_params, normed_x) -> h``.  Returns
        (x, the MoE's aux loss where ``return_aux`` and the family has one,
        else None).  ``tag``: the attention's and the MLP's outputs go through
        :func:`tp_output` (the ``save_tp_outputs`` policy).  The layer's
        ZeRO-3 weights are gathered here, inside the checkpoint
        (``gather_at_use``)."""
        cfg = self.cfg
        lp = gather_at_use(lp)
        named = (lambda h: tp_output(h, "batch", "seq_sp", "embed")) if tag else (lambda h: h)
        x = x + named(attn(lp["attn"], L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)))
        x = lshard(x, "batch", "seq_sp", "embed")
        normed = L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
        if not cfg.is_moe:
            return lshard(x + named(L.mlp_fwd(lp["mlp"], normed)), "batch", "seq_sp", "embed"), None
        out = L.moe_fwd(lp["moe"], normed, top_k=cfg.top_k,
                        capacity_factor=self.opts.moe_capacity_factor or cfg.capacity_factor,
                        return_aux=return_aux)
        h, aux = out if return_aux else (out, None)
        return lshard(x + named(h), "batch", "seq_sp", "embed"), aux

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
            prefix = batch["patches"].to(cdt) @ gather_at_use(params["patch_proj"]).to(cdt)
            x = lshard(torch.cat([prefix, x], dim=1), "batch", "seq", "embed")
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        attn = lambda ap, normed: L.attention_fwd(ap, normed, positions, causal=True,
                                                  **self._attn_kwargs())
        remat = self.opts.remat and torch.is_grad_enabled()
        save_tp = self.opts.remat_policy == "save_tp_outputs"
        contexts = {"context_fn": _save_tp_contexts} if save_tp else {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in params["layers"]:
            if remat:
                # a layer draws no random numbers: no RNG state to keep
                x, layer_aux = checkpoint(self._layer, lp, x, attn, True, save_tp,
                                          use_reentrant=False, preserve_rng_state=False,
                                          **contexts)
            else:
                x, layer_aux = self._layer(lp, x, attn, True)
            if layer_aux is not None:
                aux = aux + layer_aux.float()
        x = L.rmsnorm(gather_at_use(params["final_norm"]), x, cfg.norm_eps)
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
        x = L.rmsnorm(gather_at_use(params["final_norm"]), x, self.cfg.norm_eps)
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
