"""AdamW with decoupled weight decay + global-norm clipping, by hand (not
``torch.optim.AdamW``): the reference's ``optim/adamw.py`` step for step.

Parameters, gradients and moments are trees (dicts and lists) of tensors
mirroring each other.  Where the reference returns new trees, the port updates
the parameters and moments in place under ``torch.no_grad()`` (their storage
is reused; the step is the same arithmetic in the same order, moments in fp32)
and scales the gradients in place when clipping.  The step counter is a Python
int and the learning rate a Python float (the schedules compute in numpy
float32), so the update issues no host-device synchronisation.

DTensor trees (a meshed step) take the same update: the global norm is one
all-reduce of each rank's sums of squares over the shards it owns, the same
value on every rank, and each leaf's arithmetic runs on the local shards in
the moments' layout (ZeRO-1), the parameter gathered back where its own
layout differs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ops import is_dtensor


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, in insertion order (the
    reference's ``jax.tree.leaves`` order is sorted keys; nothing here depends
    on the order but sums taken over all leaves)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of the trees
    in ``rest``, which have ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, *vs) for vs in zip(tree, *rest, strict=True)]
    return fn(tree, *rest)


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


def init_opt_state(params, shardings=None) -> dict:
    """fp32 zero moments of the parameters' shapes and a step of 0.
    ``shardings``: a tree of ``parallel.sharding.NamedSharding`` matching
    ``params`` (the meshed step's ``opt_shardings``); each moment is then made
    in its layout, this rank's shard alone, never at full shape."""
    def zeros(p, sharding=None):
        if sharding is not None:
            from repro_torch.parallel.sharding import zeros as laid_out_zeros

            return laid_out_zeros(p.shape, sharding, torch.float32, p.device)
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    if shardings is None:
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "step": 0}
    return {"m": tree_map(zeros, params, shardings), "v": tree_map(zeros, params, shardings),
            "step": 0}


def _owned_sq(g) -> torch.Tensor:
    """A DTensor leaf's fp32 sum of squares over its local shard where this
    rank is the first of the ranks that hold that shard, else 0."""
    from torch.distributed.tensor import Partial, Replicate

    if any(isinstance(p, Partial) for p in g.placements):
        raise ValueError(f"a gradient with placements {g.placements} has no norm by shards")
    coord = g.device_mesh.get_coordinate()
    owner = all(c == 0 for c, p in zip(coord, g.placements) if isinstance(p, Replicate))
    sq = g.to_local().float().square().sum()
    return sq if owner else torch.zeros_like(sq)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares (0-d fp32).
    Over DTensors: the sum over every shard of the whole tree, one all-reduce,
    a plain tensor with the same value on every rank."""
    leaves = tree_leaves(tree)
    dist_leaves = [g for g in leaves if is_dtensor(g)]
    if not dist_leaves:
        return torch.stack([g.float().square().sum() for g in leaves]).sum().sqrt()
    from torch.distributed.tensor import DTensor, Partial

    mesh = dist_leaves[0].device_mesh
    local = torch.stack([_owned_sq(g) for g in dist_leaves]).sum()
    total = DTensor.from_local(local, mesh, [Partial()] * mesh.ndim, run_check=False)
    return total.full_tensor().sqrt()


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so that their global norm is at most ``max_norm``, the
    norm before scaling); new tensors, as the reference returns."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _update(p, g, m, v, lr, b1, b2, bc1, bc2, cfg: AdamWConfig) -> torch.Tensor:
    """One leaf's AdamW step: the moments in place, the new parameter
    returned in its dtype."""
    g32 = g.float()
    m.mul_(b1).add_(g32 * (1 - b1))                  # b1 m + (1 - b1) g
    v.mul_(b2).add_(g32.square() * (1 - b2))         # b2 v + (1 - b2) g^2
    delta = (m / bc1) / ((v / bc2).sqrt() + cfg.eps) + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype)


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
            g = g.to_local() if is_dtensor(g) else g
            g.copy_(g.float() * scale)
    b1, b2 = cfg.b1, cfg.b2
    # the bias corrections as the reference's float32 scalars
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    for p, g, m, v in zip(tree_leaves(params), flat_g, tree_leaves(state["m"]),
                          tree_leaves(state["v"]), strict=True):
        if not is_dtensor(m):
            p.copy_(_update(p, g, m, v, lr, b1, b2, bc1, bc2, cfg))
            continue
        # on this rank's shards in the moments' layout (ZeRO-1), the new
        # shards gathered back into the parameter's layout where it differs
        pl = m.placements
        new = ops.on_shards(lambda *a: _update(*a, lr, b1, b2, bc1, bc2, cfg), m.device_mesh,
                            [p, g, m, v], [pl] * 4, [pl])
        p.to_local().copy_(new.redistribute(m.device_mesh, p.placements).to_local())
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
