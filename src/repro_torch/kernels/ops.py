"""Public kernel entry points: ``rmsnorm(x, scale, eps)`` and
``flash_attention(q, k, v, causal)``, counterparts of the reference's
``kernels/ops.py``.

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


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {"rmsnorm": _rms.launches, "flash_attention": _fa.launches}


def reset_launch_counts() -> None:
    _rms.launches = 0
    _fa.launches = 0
