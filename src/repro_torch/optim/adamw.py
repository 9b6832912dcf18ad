"""AdamW with decoupled weight decay + global-norm clipping, by hand (not
``torch.optim.AdamW``): the reference's ``optim/adamw.py`` step for step.

Parameters, gradients and moments are trees (dicts and lists) of tensors
mirroring each other.  Where the reference returns new trees, the port updates
the parameters and moments in place under ``torch.no_grad()`` (their storage
is reused; the step is the same arithmetic in the same order, moments in fp32)
and scales the gradients in place when clipping.  The step counter is a Python
int and the learning rate a Python float (the schedules compute in numpy
float32), so the update issues no host-device synchronisation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in insertion order (the
    reference's ``jax.tree.leaves`` order is sorted keys; nothing here depends
    on the order but sums taken over all leaves)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[float, Callable] = 3e-4     # float or schedule(step) -> lr
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0                # global-norm clip (0 = off)

    def lr_at(self, step: int) -> float:
        """The learning rate at ``step`` as a float32 value."""
        return float(np.float32(self.lr(step) if callable(self.lr) else self.lr))


def init_opt_state(params) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": 0}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares (0-d fp32)."""
    return torch.stack([g.float().square().sum() for g in tree_leaves(tree)]).sum().sqrt()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so that their global norm is at most ``max_norm``, the
    norm before scaling); new tensors, as the reference returns."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step, in place: ``params`` and ``state``'s moments are
    updated and returned with the metrics {"grad_norm" (0-d tensor), "lr"};
    ``grads`` are scaled in place when clipping is on."""
    step = state["step"] + 1
    lr = cfg.lr_at(step)
    flat_g = tree_leaves(grads)
    gnorm = global_norm(flat_g)
    if cfg.grad_clip:
        scale = _clip_scale(gnorm, cfg.grad_clip)
        for g in flat_g:
            g.copy_(g.float() * scale)
    b1, b2 = cfg.b1, cfg.b2
    # the bias corrections as the reference's float32 scalars
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    for p, g, m, v in zip(tree_leaves(params), flat_g, tree_leaves(state["m"]),
                          tree_leaves(state["v"]), strict=True):
        g32 = g.float()
        m.mul_(b1).add_(g32 * (1 - b1))                  # b1 m + (1 - b1) g
        v.mul_(b2).add_(g32.square() * (1 - b2))         # b2 v + (1 - b2) g^2
        delta = (m / bc1) / ((v / bc2).sqrt() + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
