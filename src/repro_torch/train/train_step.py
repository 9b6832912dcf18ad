"""The train and serve steps: loss, gradients with microbatch accumulation,
and the AdamW update -- the reference's ``train/train_step.py``.

The parameters are leaf tensors with ``requires_grad``.  The gradients of
fp32 leaves land in their ``.grad`` (autograd casts the compute-dtype
cotangent back at each ``.to``); those of other leaves (bf16 weights) are
summed into fp32 buffers, as the reference sums into fp32 zeros.
``adamw_update`` changes parameters and moments in place.

With a ``mesh`` (a :class:`~torch.distributed.device_mesh.DeviceMesh` over
``data``/``model``, optionally ``pod``) the steps run on DTensors: the
parameters are laid out by ``parallel.sharding.param_shardings`` (TP/EP over
``model``, ZeRO-3 over the data dimensions), the moments by
``opt_shardings`` (ZeRO-1), the step counter is a Python int on every rank,
and each microbatch is sharded over the data dimensions where its first
dimension divides them.  No step gathers the whole tree: the models gather
each layer's ZeRO-3 weights over the data dimensions at their use
(``parallel.sharding.gather_at_use``, a differentiable ``redistribute``,
inside the layer's checkpoint, so that the recompute gathers them again), and
the backward reduce-scatters each layer's gradients into their parameters'
layout as that layer's backward ends.  Plain tensors
(every rank holding the whole tree, as ``model.init`` on a common seed gives
them) are accepted on the first call, as ``jit``'s ``in_shardings`` accept
host arrays, and laid out; the step returns DTensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWConfig, adamw_update, tree_leaves, tree_map
from repro_torch.parallel import sharding as shd


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy (or torch) batch arrays as tensors on ``device``."""
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _leaves_without_grad(grads, path: str = "params") -> list[str]:
    """The paths of the leaves whose gradient is None."""
    if isinstance(grads, dict):
        return [m for k, v in grads.items() for m in _leaves_without_grad(v, f"{path}[{k!r}]")]
    if isinstance(grads, list):
        return [m for i, v in enumerate(grads) for m in _leaves_without_grad(v, f"{path}[{i}]")]
    return [path] if grads is None else []


def loss_and_grads(model, params, batch: dict, microbatches: int = 1, layout=None):
    """(loss, metrics, grads) with gradient accumulation over microbatches,
    as the reference's: each microbatch's gradients are summed in fp32 in
    order, then the sum and the loss are scaled by 1/microbatches; metrics are
    the last microbatch's.  ``grads`` is a tree of fp32 tensors: an fp32
    leaf's ``.grad``, or for a leaf of another dtype an fp32 buffer that
    holds the sum of its microbatch gradients (its ``.grad`` is left None).
    Raises, naming the leaves, if the loss reaches a leaf with no gradient:
    every leaf of a model takes part in its loss, so a missing gradient means
    an op returned a tensor that autograd did not record.  ``layout(params,
    microbatch) -> (params, microbatch)``: what the loss sees of each
    microbatch (the meshed step's sharding of the microbatch); None is the
    identity."""
    layout = layout or (lambda p, b: (p, b))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    sums = [None] * len(leaves)   # the fp32 sums of the leaves that are not fp32

    def accumulate():
        for i, p in enumerate(leaves):
            if p.dtype != torch.float32 and p.grad is not None:
                sums[i] = p.grad.float() if sums[i] is None else sums[i].add_(p.grad)
                p.grad = None

    if microbatches <= 1:
        loss, metrics = model.loss(*layout(params, batch))
        loss.backward()
        accumulate()
        loss = loss.detach()
    else:
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        mb = b // microbatches
        loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        for i in range(microbatches):
            part, metrics = model.loss(*layout(params, {k: v[i * mb: (i + 1) * mb]
                                                        for k, v in batch.items()}))
            part.backward()   # .grad += this microbatch's gradient
            accumulate()
            loss = loss + part.detach()
    flat = iter([p.grad if s is None else s for p, s in zip(leaves, sums)])
    grads = tree_map(lambda _: next(flat), params)
    missing = _leaves_without_grad(grads)
    if missing:
        more = f" and {len(missing) - 3} more" if len(missing) > 3 else ""
        raise RuntimeError(f"the loss sent no gradient to {', '.join(missing[:3])}{more}: an op "
                           "on the way cut the graph")
    if microbatches > 1:
        inv = 1.0 / microbatches
        loss = loss * inv
        for g in tree_leaves(grads):
            g.mul_(inv)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss, metrics, grads


def make_train_step(model, opt_cfg: AdamWConfig, mesh=None, microbatches: int = 1,
                    rules: dict | None = None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on the model's device; the batch may be numpy.  Parameters and
    moments are updated in place (the reference donates their buffers).  With
    a ``mesh``: see the module's docstring; the metrics come back as plain
    tensors, the same on every rank, and ``train_step.state_shardings(params)``
    gives the layouts of ``{"params", "opt"}``.  ``rules``: the logical-axis
    rule table (``parallel.sharding.default_rules`` of the mesh when None)."""
    if mesh is None:
        def train_step(params, opt_state, batch):
            batch = batch_to_device(batch, model.device)
            loss, metrics, grads = loss_and_grads(model, params, batch, microbatches)
            params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg)
            return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

        return train_step

    layouts: dict = {}

    def state_shardings(params) -> dict:
        key = _shapes(params)
        if key not in layouts:
            opt = shd.opt_shardings(params, mesh, rules)
            layouts[key] = {"params": shd.param_shardings(params, mesh, rules),
                            "opt": {"m": opt, "v": opt, "step": None}}
        return layouts[key]

    def layout(params, mbatch):
        return params, shard_batch(mbatch, mesh, rules)

    def train_step(params, opt_state, batch):
        batch = batch_to_device(batch, model.device)
        batch = {k: shd.full_tensor(v) for k, v in batch.items()}
        lay = state_shardings(params)
        params = shd.lay_out_tree(params, lay["params"])
        opt_state = {"m": shd.lay_out_tree(opt_state["m"], lay["opt"]["m"]),
                     "v": shd.lay_out_tree(opt_state["v"], lay["opt"]["v"]),
                     "step": int(opt_state["step"])}
        with shd.activate(mesh, rules):
            loss, metrics, grads = loss_and_grads(model, params, batch, microbatches, layout)
            params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg)
        metrics = {"loss": loss, **metrics, **opt_metrics}
        return params, opt_state, {k: shd.full_tensor(v) for k, v in metrics.items()}

    train_step.state_shardings = state_shardings
    return train_step


def _shapes(tree) -> tuple:
    """The shapes of a tree's tensor leaves, in order: what its layouts
    depend on."""
    return tuple(tuple(t.shape) for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def batch_sharding(leaf, mesh, rules: dict | None = None) -> "shd.NamedSharding":
    """A batch leaf's layout: its first dimension over the data dimensions
    where it divides them (the rules' ``batch``), else replicated."""
    names = ("batch",) + (None,) * (len(leaf.shape) - 1)
    rules = rules or shd.default_rules(mesh.mesh_dim_names)
    return shd.NamedSharding(mesh, shd.resolve_spec(names, leaf.shape, mesh, rules))


def shard_batch(batch: dict, mesh, rules: dict | None = None) -> dict:
    return {k: shd.lay_out(v, batch_sharding(v, mesh, rules)) for k, v in batch.items()}


def make_serve_step(model, mesh=None, rules: dict | None = None):
    """``serve_step(params, cache, tokens) -> (logits, cache)``: one-token
    decode (the cache is updated in place, as the reference donates it).
    With a ``mesh`` the parameters are laid out by ``param_shardings`` and the
    cache by :func:`cache_shardings` (on the first call; ``serve_step.lay_out
    (params, cache)`` does it ahead), the tokens replicated; the decode
    gathers each layer's ZeRO-3 weights as it reaches the layer
    (``parallel.sharding.gather_at_use``) and frees them after it; the logits
    come back as a DTensor.  ``rules`` as in :func:`make_train_step`."""
    if mesh is None:
        def serve_step(params, cache, tokens):
            return model.decode_step(params, cache, tokens)

        return serve_step

    layouts: dict = {}

    def lay_out(params, cache):
        key = (_shapes(params), _shapes(cache))
        if key not in layouts:
            layouts[key] = (shd.param_shardings(params, mesh, rules),
                            cache_shardings(cache, mesh, rules, model=model))
        p_lay, c_lay = layouts[key]
        return shd.lay_out_tree(params, p_lay), shd.lay_out_tree(cache, c_lay)

    def serve_step(params, cache, tokens):
        params, cache = lay_out(params, cache)
        tokens = shd.lay_out(shd.full_tensor(tokens), shd.NamedSharding(mesh, (None,) * tokens.ndim))
        with shd.activate(mesh, rules):
            return model.decode_step(params, cache, tokens)

    serve_step.lay_out = lay_out
    return serve_step


def cache_shardings(cache, mesh, rules=None, model=None):
    """KV caches and recurrent states: batch over the data dimensions; KV
    heads over ``model`` when the GQA head count divides it, else the
    sequence dimension (flash-decoding-style partial attention); SSM/mLSTM
    heads over ``model``.  Logical names come from the model's
    ``cache_axes()`` (its exact layout); a foreign cache tree falls back to
    the reference's rank-based rule.  Leaves that are not tensors (the
    index) get None."""
    sizes = shd.mesh_shape(mesh)
    rules = rules or shd.default_rules(tuple(sizes))
    model_size = sizes.get("model", 1)

    def resolve_names(names, shape):
        local_rules = dict(rules)
        names = list(names)
        if "kv_heads" in names:
            hd_idx = names.index("kv_heads")
            if shape[hd_idx] % model_size == 0:
                local_rules["kv_seq"] = ()
            else:
                names[hd_idx] = None
                local_rules["kv_seq"] = ("model",)
        for name in ("kv_seq", "layers", "units", "per_unit"):
            local_rules.setdefault(name, ())
        return shd.NamedSharding(mesh, shd.resolve_spec(names, shape, mesh, local_rules))

    def shape_of(leaf):
        return tuple(leaf.shape) if hasattr(leaf, "shape") else None

    if model is not None and hasattr(model, "cache_axes"):
        def walk(axes, leaf):
            if isinstance(leaf, dict):
                return {k: walk(axes[k], v) for k, v in leaf.items()}
            shape = shape_of(leaf)
            if not shape:
                return None if shape is None else shd.NamedSharding(mesh, ())
            return resolve_names(axes, shape)

        return walk(model.cache_axes(), cache)

    def f(path, leaf):
        shape = shape_of(leaf)
        if not shape:
            return None if shape is None else shd.NamedSharding(mesh, ())
        names: list = [None] * len(shape)
        ndim = len(shape)
        if ("kv" in path or "cross" in path) and ndim >= 4:
            names[-4] = "batch"
            names[-2] = "kv_heads"
            names[-3] = "kv_seq"
        elif path.endswith("S") or "states" in path:
            if ndim >= 4:
                names[-3] = "ssm_heads"
        return resolve_names(names, shape)

    return shd.map_with_path(f, cache)
