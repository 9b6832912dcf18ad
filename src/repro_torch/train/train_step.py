"""The train step: loss, gradients with microbatch accumulation, and the
AdamW update -- the reference's ``train/train_step.py`` for one device.

The parameters are leaf tensors with ``requires_grad``.  The gradients of
fp32 leaves land in their ``.grad`` (autograd casts the compute-dtype
cotangent back at each ``.to``); those of other leaves (bf16 weights) are
summed into fp32 buffers, as the reference sums into fp32 zeros.
``adamw_update`` changes parameters and moments in place.  The reference's
meshed step (pjit shardings, ZeRO-1) waits for the parallelism layer,
ROADMAP queue A item 6.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWConfig, adamw_update, tree_leaves, tree_map


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


def loss_and_grads(model, params, batch: dict, microbatches: int = 1):
    """(loss, metrics, grads) with gradient accumulation over microbatches,
    as the reference's: each microbatch's gradients are summed in fp32 in
    order, then the sum and the loss are scaled by 1/microbatches; metrics are
    the last microbatch's.  ``grads`` is a tree of fp32 tensors: an fp32
    leaf's ``.grad``, or for a leaf of another dtype an fp32 buffer that
    holds the sum of its microbatch gradients (its ``.grad`` is left None).
    Raises, naming the leaves, if the loss reaches a leaf with no gradient:
    every leaf of a model takes part in its loss, so a missing gradient means
    an op returned a tensor that autograd did not record."""
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
        loss, metrics = model.loss(params, batch)
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
            part, metrics = model.loss(params, {k: v[i * mb: (i + 1) * mb] for k, v in batch.items()})
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


def make_train_step(model, opt_cfg: AdamWConfig, mesh=None, microbatches: int = 1):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on the model's device; the batch may be numpy.  Parameters and
    moments are updated in place (the reference donates their buffers)."""
    if mesh is not None:
        raise NotImplementedError("a meshed train step needs the parallelism layer "
                                  "(ROADMAP.md, queue A item 6)")

    def train_step(params, opt_state, batch):
        batch = batch_to_device(batch, model.device)
        loss, metrics, grads = loss_and_grads(model, params, batch, microbatches)
        params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
