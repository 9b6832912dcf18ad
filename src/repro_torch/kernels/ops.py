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
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd_chunk as _ssd


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
    if _records_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal)
    if q.is_cuda:
        return _fa.flash_attention_cuda(q, k, v, causal)
    _fa.check_shapes(q, k, v, causal)
    return ref.flash_attention_ref(q, k, v, causal)


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
