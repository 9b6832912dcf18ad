"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Counterpart of the reference's Pallas ``kernels/rmsnorm.py``.  The wrapper
checks what the kernel takes, allocates the output, launches on PyTorch's
current stream and raises if the launch was refused.  It does not
synchronise.  ``launches`` counts kernel launches (and nothing else), so a
run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


@functools.cache
def _fn():
    fn = _build.load("rmsnorm").rmsnorm_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, scale, out
        ctypes.c_int, ctypes.c_int,                           # dtype codes
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float,      # rows, d, eps
        ctypes.c_void_p,                                      # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d) fp32 or bf16 on a CUDA device; scale: (d,) fp32 or bf16."""
    global launches
    if not x.is_cuda or scale.device != x.device:
        raise ValueError(f"rmsnorm_cuda needs CUDA tensors on one device, got {x.device}, {scale.device}")
    if x.dtype not in DTYPE_CODES or scale.dtype not in DTYPE_CODES:
        raise TypeError(f"rmsnorm_cuda takes float32/bfloat16, got x {x.dtype}, scale {scale.dtype}")
    if x.dim() < 1 or scale.shape != (x.shape[-1],):
        raise ValueError(f"scale {tuple(scale.shape)} does not match x {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError("rmsnorm_cuda got an empty tensor")
    x = x.contiguous()
    scale = scale.contiguous()
    out = torch.empty_like(x)
    d = x.shape[-1]
    with torch.cuda.device(x.device):   # a launch goes to the current device
        err = _fn()(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype],
            x.numel() // d, d, float(eps),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed (cudaError {err}) for x {tuple(x.shape)} {x.dtype}")
    launches += 1
    return out
