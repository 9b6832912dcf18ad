"""The train step: loss, gradients with microbatch accumulation, and the
AdamW update -- the reference's ``train/train_step.py`` for one device.

The parameters are leaf tensors with ``requires_grad``; the gradients land in
their ``.grad`` (fp32 for fp32 masters: autograd casts the compute-dtype
cotangent back at each ``.to``), and ``adamw_update`` changes parameters and
moments in place.  The reference's meshed step (pjit shardings, ZeRO-1) waits
for the parallelism layer, ROADMAP queue A item 6.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.optim.adamw import AdamWConfig, adamw_update, tree_leaves, tree_map


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """numpy (or torch) batch arrays as tensors on ``device``."""
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v).to(device)
            for k, v in batch.items()}


def _leaves_without_grad(tree, path: str = "params") -> list[str]:
    """The paths of the leaves whose ``.grad`` is None."""
    if isinstance(tree, dict):
        return [m for k, v in tree.items() for m in _leaves_without_grad(v, f"{path}[{k!r}]")]
    if isinstance(tree, list):
        return [m for i, v in enumerate(tree) for m in _leaves_without_grad(v, f"{path}[{i}]")]
    return [path] if tree.grad is None else []


def loss_and_grads(model, params, batch: dict, microbatches: int = 1):
    """(loss, metrics, grads) with gradient accumulation over microbatches,
    as the reference's: each microbatch's gradients are summed in fp32 in
    order, then the sum and the loss are scaled by 1/microbatches; metrics are
    the last microbatch's.  ``grads`` is a tree of the leaves' ``.grad``.
    Raises, naming the leaves, if the loss reaches a leaf with no gradient:
    every leaf of a model takes part in its loss, so a missing gradient means
    an op returned a tensor that autograd did not record."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    if microbatches <= 1:
        loss, metrics = model.loss(params, batch)
        loss.backward()
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
            loss = loss + part.detach()
    missing = _leaves_without_grad(params)
    if missing:
        more = f" and {len(missing) - 3} more" if len(missing) > 3 else ""
        raise RuntimeError(f"the loss sent no gradient to {', '.join(missing[:3])}{more}: an op "
                           "on the way cut the graph")
    if microbatches > 1:
        inv = 1.0 / microbatches
        loss = loss * inv
        for p in leaves:
            p.grad.mul_(inv)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss, metrics, tree_map(lambda p: p.grad, params)


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
