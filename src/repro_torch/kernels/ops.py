"""Public kernel entry points: ``rmsnorm(x, scale, eps)``,
``flash_attention(q, k, v, causal)`` and ``ssd_chunk_scan(x, B, C, dt, loga,
chunk)``, counterparts of the reference's ``kernels/ops.py``.

Dispatch is on the tensor's device and on nothing else: a CUDA tensor launches
the hand-written kernel or raises, a CPU tensor takes the plain PyTorch
version in ``kernels.ref``.  There is no option that hands back the plain
version for a CUDA tensor and no ``try`` around the build or the launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd_chunk as _ssd


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d) -> same shape and dtype; fp32 statistics."""
    if x.is_cuda:
        return _rms.rmsnorm_cuda(x, scale, eps)
    return ref.rmsnorm_ref(x, scale, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (b, hq, sq, hd); k/v: (b, hkv, skv, hd) -> (b, hq, sq, hd).
    ``causal`` with ``sq > skv`` is rejected on every device."""
    if q.is_cuda:
        return _fa.flash_attention_cuda(q, k, v, causal)
    _fa.check_shapes(q, k, v, causal)
    return ref.flash_attention_ref(q, k, v, causal)


def ssd_chunk_scan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dt: torch.Tensor,
                   loga: torch.Tensor, chunk: int = 128, out_dtype: torch.dtype | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, H, s, P); B/C: (b, H, s, N); dt/loga: (b, H, s), fp32 ->
    (y (b, H, s, P) in ``out_dtype`` or x.dtype, S_final (b, H, P, N) fp32).
    ``s`` must be a multiple of ``min(chunk, s)`` on every device."""
    if x.is_cuda:
        return _ssd.ssd_chunk_scan_cuda(x, B, C, dt, loga, chunk, out_dtype)
    chunk = _ssd.check_shapes(x, B, C, dt, loga, chunk)
    return ref.ssd_chunk_scan_ref(x, B, C, dt, loga, chunk, out_dtype)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {"rmsnorm": _rms.launches, "flash_attention": _fa.launches,
            "ssd_chunk_scan": _ssd.launches}


def reset_launch_counts() -> None:
    _rms.launches = 0
    _fa.launches = 0
    _ssd.launches = 0
