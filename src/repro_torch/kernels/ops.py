"""Public kernel entry points: ``rmsnorm(x, scale, eps)``,
``flash_attention(q, k, v, causal)`` and ``ssd_chunk_scan(x, B, C, dt, loga,
chunk)``, counterparts of the reference's ``kernels/ops.py``.

Dispatch is on the tensor's device and on nothing else: a CUDA tensor launches
the hand-written kernel or raises, a CPU tensor takes the plain PyTorch
version in ``kernels.ref``.  There is no option that hands back the plain
version for a CUDA tensor and no ``try`` around the build or the launch.

Where autograd will need a gradient, all three run as
``torch.autograd.Function``s whose backward is the hand-written backward
kernel on a CUDA tensor and the plain analytic backward (``ref.*_bwd_ref``) on
a CPU tensor; the flash forward then also returns the log-sum-exp the backward
takes and, below fp32, what rounding its output dropped (the backward's D reads
the unrounded output).  Otherwise they call the forward alone, as serving does.

A ``DTensor`` input (the meshed steps of :mod:`repro_torch.parallel`) is first
brought to placements the op computes shard by shard -- RMSNorm's feature
dimension, attention's sequence and head dimension, the scan's sequence and
state replicated; batch and heads may stay sharded -- and the same dispatch
then runs on each rank's local shard, forward and backward, the result wrapped
back as a DTensor.  An input replicated where the output is sharded gets a
gradient that is a partial sum over that mesh dimension.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd_chunk as _ssd


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor   # imported on use: it takes a second

    return isinstance(x, DTensor)


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _kept(placements, keep_dims: tuple) -> list:
    """``placements`` with every placement but ``Shard`` of one of
    ``keep_dims`` turned to ``Replicate`` (a ``Partial`` is reduced)."""
    from torch.distributed.tensor import Replicate, Shard

    return [p if isinstance(p, Shard) and p.dim in keep_dims else Replicate() for p in placements]


def on_shards(fn, mesh, args: list, placements: list, outs: list):
    """``fn`` on the local shards of ``args`` laid out at ``placements``, its
    outputs DTensors at ``outs`` (``fn`` may return None: an update of the
    shards in place).  An argument replicated on a mesh dimension where the
    first argument is sharded gets a partial-sum gradient there.  The one
    place where an op of the port leaves DTensors for local shards and back:
    the kernels here, attention and the SSM's conv in the models, the MoE's
    routing and combine, a cache write, AdamW's update."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    locals_ = []
    for a, pl in zip(args, placements):
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        grad_pl = [Partial() if isinstance(p0, Shard) and not isinstance(p, Shard) else p
                   for p0, p in zip(placements[0], pl)]
        # also where ``a`` is laid out so already: the backward then reduces
        # a partial gradient into ``a``'s layout; the local shard is ``a``'s
        locals_.append(a.redistribute(mesh, pl).to_local(grad_placements=grad_pl))
    out = fn(*locals_)
    wrap = lambda t, pl: None if t is None else DTensor.from_local(t, mesh, pl, run_check=False)
    if isinstance(out, tuple):
        return tuple(wrap(t, pl) for t, pl in zip(out, outs))
    return None if out is None else wrap(out, outs[0])


def _rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    if x.is_cuda:
        return _rms.rmsnorm_cuda(x, scale, eps)
    return ref.rmsnorm_ref(x, scale, eps)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return _rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        if dy.is_cuda:
            dx, dscale = _rms.rmsnorm_bwd_cuda(x, scale, dy, ctx.eps)
        else:
            dx, dscale = ref.rmsnorm_bwd_ref(x, scale, dy, ctx.eps)
        return dx, dscale.to(scale.dtype), None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d) -> same shape and dtype; fp32 statistics."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        mesh = x.device_mesh
        pl = _kept(x.placements, tuple(range(x.ndim - 1)))
        return on_shards(lambda a, s: rmsnorm(a, s, eps), mesh, [x, scale],
                         [pl, [Replicate()] * mesh.ndim], [pl])
    if _records_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    return _rmsnorm_fwd(x, scale, eps)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda:
            out, lse, out_res = _fa.flash_attention_cuda(q, k, v, causal, with_lse=True)
        else:
            _fa.check_shapes(q, k, v, causal)
            out32, lse = ref.flash_attention_lse_ref(q.float(), k.float(), v.float(), causal)
            out = out32.to(q.dtype)
            # as the kernel: below fp32, what rounding out dropped, for D
            out_res = None if q.dtype == torch.float32 else (out32 - out.float()).to(q.dtype)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse, out_res)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, out_res = ctx.saved_tensors
        if dout.is_cuda:
            grads = _fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, ctx.causal, out_res)
        else:
            grads = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, ctx.causal, out_res)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (b, hq, sq, hd); k/v: (b, hkv, skv, hd) -> (b, hq, sq, hd).
    ``causal`` with ``sq > skv`` is rejected on every device."""
    if is_dtensor(q):
        return heads_on_shards(lambda a, b, c: flash_attention(a, b, c, causal), q, k, v, 1)
    if _records_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)
    if q.is_cuda:
        return _fa.flash_attention_cuda(q, k, v, causal)
    _fa.check_shapes(q, k, v, causal)
    return ref.flash_attention_ref(q, k, v, causal)


def heads_on_shards(fn, q, k, v, head_dim: int, extra: tuple = ()):
    """``fn(q, k, v, *extra) -> out`` (attention, ``out`` in q's layout) on
    the local shards of DTensors: batch (dim 0) and heads (``head_dim``) may
    stay sharded, the rest is replicated.  Where the query heads are sharded
    over mesh dimensions whose size does not divide the KV heads, K/V stay
    replicated there and each rank reads the KV head of each of its query
    heads (the group map of GQA).  ``extra`` (a per-lane mask) is laid out
    with q's batch sharding and replicated elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    pq = _kept(q.placements, (0, head_dim))
    head_dims = [i for i, p in enumerate(pq) if p == Shard(head_dim)]
    n_split = 1
    for i in head_dims:
        n_split *= mesh.size(i)
    kv_split = k.shape[head_dim] % n_split == 0
    pkv = [Replicate() if p == Shard(head_dim) and not kv_split else p for p in pq]
    args = [q, k, v, *extra]
    pls = [pq, pkv, pkv] + [_kept(pq, (0,))] * len(extra)
    if kv_split or not head_dims:
        return on_shards(fn, mesh, args, pls, [pq])
    coord = mesh.get_coordinate()
    shard = 0
    for i in head_dims:   # this rank's block of query heads, major first
        shard = shard * mesh.size(i) + coord[i]
    h_local, group = q.shape[head_dim] // n_split, q.shape[head_dim] // k.shape[head_dim]

    def local(a, b, c, *rest):
        idx = torch.arange(shard * h_local, (shard + 1) * h_local, device=a.device) // group
        return fn(a, b.index_select(head_dim, idx), c.index_select(head_dim, idx), *rest)

    return on_shards(local, mesh, args, pls, [pq])


def _ssd_fwd(x, B, C, dt, loga, chunk, out_dtype):
    if x.is_cuda:
        return _ssd.ssd_chunk_scan_cuda(x, B, C, dt, loga, chunk, out_dtype)
    chunk = _ssd.check_shapes(x, B, C, dt, loga, chunk)
    return ref.ssd_chunk_scan_ref(x, B, C, dt, loga, chunk, out_dtype)


class _SSDChunkScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, B, C, dt, loga, chunk, out_dtype):
        ctx.set_materialize_grads(False)   # S_final's gradient is None where it is dropped
        ctx.chunk = chunk
        ctx.save_for_backward(x, B, C, dt, loga)
        return _ssd_fwd(x, B, C, dt, loga, chunk, out_dtype)

    @staticmethod
    def backward(ctx, dy, dS_final):
        x, B, C, dt, loga = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        if x.is_cuda:
            grads = _ssd.ssd_chunk_scan_bwd_cuda(x, B, C, dt, loga, dy, dS_final, ctx.chunk)
        else:
            grads = ref.ssd_chunk_scan_bwd_ref(x, B, C, dt, loga, dy, dS_final, ctx.chunk)
        return (*grads, None, None)


def ssd_chunk_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dt: torch.Tensor,
                   loga: torch.Tensor, chunk: int = 128, out_dtype: torch.dtype | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, H, s, P); B/C: (b, H, s, N), or (b, s, N) shared by the heads
    (their gradient is then summed over the heads); dt/loga: (b, H, s), fp32
    -> (y (b, H, s, P) in ``out_dtype`` or x.dtype, S_final (b, H, P, N) fp32).
    ``s`` must be a multiple of ``min(chunk, s)`` on every device."""
    if is_dtensor(x):
        mesh = x.device_mesh
        px = _kept(x.placements, (0, 1))
        pbc = px if B.ndim == 4 else _kept(px, (0,))
        return on_shards(lambda *a: ssd_chunk_scan(*a, chunk, out_dtype), mesh,
                         [x, B, C, dt, loga], [px, pbc, pbc, px, px], [px, px])
    if _records_grad(x, B, C, dt, loga):
        return _SSDChunkScan.apply(x, B, C, dt, loga, chunk, out_dtype)
    return _ssd_fwd(x, B, C, dt, loga, chunk, out_dtype)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name (a backward
    counts one per call of its wrapper)."""
    return {"rmsnorm": _rms.launches, "flash_attention": _fa.launches,
            "ssd_chunk_scan": _ssd.launches, "rmsnorm_bwd": _rms.bwd_launches,
            "flash_attention_bwd": _fa.bwd_launches, "ssd_chunk_scan_bwd": _ssd.bwd_launches}


def reset_launch_counts() -> None:
    _rms.launches = _rms.bwd_launches = 0
    _fa.launches = _fa.bwd_launches = 0
    _ssd.launches = _ssd.bwd_launches = 0
