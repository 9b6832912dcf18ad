"""Distributed-optimization collectives: gradient compression with error
feedback, and a compressed data-parallel mean over a process group -- the
reference's ``parallel/collectives.py`` in ``torch.distributed`` terms.

The DP gradient synchronization volume ``v_d`` -- the quantity Arnold's comm
matrix tracks -- can be halved (fp16) or quartered (int8) on the wire.  Error
feedback keeps the compression unbiased over time: the quantization residual
is added back into the next step's gradient, which preserves convergence
(Karimireddy et al., 2019).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map


# ------------------------------------------------------------- quantization
def quantize_fp16(g: torch.Tensor) -> torch.Tensor:
    return g.to(torch.float16)


def dequantize_fp16(q: torch.Tensor, _meta=None) -> torch.Tensor:
    return q.to(torch.float32)


def quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 with an fp32 scale (round half to even)."""
    absmax = torch.clamp(g.abs().max(), min=1e-12)
    scale = absmax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


# ------------------------------------------------------------ error feedback
def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _roundtrip(x: torch.Tensor, scheme: str) -> torch.Tensor:
    if scheme == "fp16":
        return dequantize_fp16(quantize_fp16(x))
    if scheme == "int8":
        return dequantize_int8(*quantize_int8(x))
    raise ValueError(scheme)


def compress_with_feedback(grads, residuals, scheme: str = "fp16"):
    """Quantize (grads + carried residual); return (compressed-as-fp32 grads,
    new residuals).  The returned grads are exactly what the receiving side
    reconstructs, so the optimizer sees the true compressed values."""
    flat_r = iter(tree_leaves(residuals))
    pairs = []

    def one(g):
        x = g.to(torch.float32) + next(flat_r)
        deq = _roundtrip(x, scheme)
        pairs.append((deq, x - deq))
        return deq

    out = tree_map(one, grads)
    new_res = iter([r for _, r in pairs])
    return out, tree_map(lambda _: next(new_res), grads)


# ------------------------------------------------- compressed DP all-reduce
def _mean_of_payloads(g: torch.Tensor, group, scheme: str) -> torch.Tensor:
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if scheme == "fp16":
        q = quantize_fp16(g)
        parts = [torch.empty_like(q) for _ in range(n)]
        dist.all_gather(parts, q, group=group)               # wire: fp16
        vals = [dequantize_fp16(p) for p in parts]
    elif scheme == "int8":
        q, scale = quantize_int8(g.to(torch.float32))
        parts = [torch.empty_like(q) for _ in range(n)]
        scales = [torch.empty_like(scale) for _ in range(n)]
        dist.all_gather(parts, q, group=group)               # wire: int8 + one fp32 scale
        dist.all_gather(scales, scale, group=group)
        vals = [dequantize_int8(p, s) for p, s in zip(parts, scales)]
    else:
        s = g.to(torch.float32).clone()
        dist.all_reduce(s, group=group)
        return s / n
    total = vals[0]
    for v in vals[1:]:
        total = total + v
    return total / n


def compressed_psum_mean(tree, group=None, scheme: str = "fp16"):
    """Mean over the ranks of ``group`` whose wire payload is quantized: each
    rank quantizes its own contribution, the payloads travel in the narrow
    dtype (fp16, or int8 with one fp32 scale), every rank dequantizes them
    and sums in fp32 in rank order, and the mean is taken in fp32.  Any
    other ``scheme`` is the plain fp32 all-reduce mean."""
    return tree_map(lambda g: _mean_of_payloads(g, group, scheme), tree)


def make_dp_grad_fn(loss_fn, mesh, axis_name: str = "data", scheme: str = "fp16"):
    """Data-parallel value-and-grad with a compressed gradient mean: each rank
    of ``mesh``'s ``axis_name`` dimension computes ``loss_fn(params,
    batch) -> (loss, metrics)`` on its block of the batch's rows, then
    :func:`compressed_psum_mean` over that dimension's group synchronizes the
    gradients and the loss is averaged (fp32).  ``params``: a tree of plain
    tensors, the same on every rank; returns (loss, grads)."""
    import torch.distributed as dist

    group = mesh.get_group(axis_name)
    dim = mesh.mesh_dim_names.index(axis_name)

    def fn(params, batch: dict):
        n, i = mesh.size(dim), mesh.get_coordinate()[dim]
        local = {k: v.chunk(n, dim=0)[i] for k, v in batch.items()}
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(leaves)
        loss, _ = loss_fn(tree_map(lambda _: next(it), params), local)
        grads = torch.autograd.grad(loss, leaves)
        git = iter(grads)
        grads = compressed_psum_mean(tree_map(lambda _: next(git), params), group, scheme)
        loss = loss.detach().to(torch.float32).clone()
        dist.all_reduce(loss, group=group)
        return loss / n, grads

    return fn
