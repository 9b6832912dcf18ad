"""Wrapper of the CUDA Mamba2 SSD chunk-scan forward kernel
(``csrc/ssd_chunk.cu``).

Counterpart of the reference's Pallas ``kernels/ssd_chunk.py``, with its
public layout: ``x (b, H, s, P)``, ``B/C (b, H, s, N)``, ``dt/loga (b, H, s)``
-> ``(y (b, H, s, P), S_final (b, H, P, N) fp32)``, ``chunk = min(chunk, s)``
and ``s % chunk == 0``.  The kernel reads every tensor through its batch,
head and sequence strides, so the model's ``(b, s, H, P)`` x goes in as a
transposed view and its ``(b, s, N)`` B/C, shared by all heads, as expanded
views with head stride 0; only the last axis of x, B and C must be
contiguous.  ``y`` is allocated in x's layout when x is held sequence-major
(heads inside sequence, as the model holds it), else as ``(b, H, s, P)``.
``y`` is in ``x.dtype`` (the Pallas contract) unless ``out_dtype`` says
otherwise; ``S_final`` is always fp32.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_P, MAX_N = 128, 64, 64   # the kernel's shared-memory layout

launches = 0


@functools.cache
def _fn():
    fn = _build.load("ssd_chunk").ssd_chunk_scan_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x B C
        ctypes.c_void_p, ctypes.c_void_p,                    # dt loga
        ctypes.c_void_p, ctypes.c_void_p,                    # y S_final
        ctypes.c_int, ctypes.c_int,                          # dtype codes: in, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # b H s
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # P N chunk
        ctypes.POINTER(ctypes.c_longlong),                   # strides
        ctypes.c_void_p,                                     # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def check_shapes(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dt: torch.Tensor,
                 loga: torch.Tensor, chunk: int) -> int:
    """Shape rules shared by the kernel and its plain version; returns the
    chunk length actually used, ``min(chunk, s)``."""
    if x.dim() != 4 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"expected x (b,H,s,P), B/C (b,H,s,N); got {tuple(x.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, H, s, _ = x.shape
    if B.shape[:3] != (b, H, s) or dt.shape != (b, H, s) or loga.shape != (b, H, s):
        raise ValueError(f"x {tuple(x.shape)}, B {tuple(B.shape)}, dt {tuple(dt.shape)}, "
                         f"loga {tuple(loga.shape)} do not share (b, H, s)")
    if min(x.shape) < 1 or B.shape[-1] < 1 or chunk < 1:
        raise ValueError(f"empty SSD problem: x {tuple(x.shape)}, B {tuple(B.shape)}, chunk {chunk}")
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}; pad first")
    return chunk


def _output(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Uninitialised (b, H, s, P) in ``dtype``, laid out as (b, s, H, P) when
    x is held that way."""
    b, H, s, P = x.shape
    if H > 1 and s > 1 and x.stride(1) < x.stride(2):
        return torch.empty((b, s, H, P), dtype=dtype, device=x.device).transpose(1, 2)
    return torch.empty((b, H, s, P), dtype=dtype, device=x.device)


def ssd_chunk_scan_cuda(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dt: torch.Tensor,
                        loga: torch.Tensor, chunk: int = 128,
                        out_dtype: torch.dtype | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    chunk = check_shapes(x, B, C, dt, loga, chunk)
    tensors = (x, B, C, dt, loga)
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError(f"ssd_chunk_scan_cuda needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    out_dtype = out_dtype or x.dtype
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype \
            or out_dtype not in DTYPE_CODES:
        raise TypeError(f"ssd_chunk_scan_cuda takes x/B/C float32 or bfloat16 of one type and "
                        f"a float32/bfloat16 output, got {x.dtype}, {B.dtype}, {C.dtype} -> {out_dtype}")
    if dt.dtype != torch.float32 or loga.dtype != torch.float32:
        raise TypeError(f"dt and loga must be float32, got {dt.dtype}, {loga.dtype}")
    b, H, s, P = x.shape
    N = B.shape[-1]
    if chunk > MAX_CHUNK or P > MAX_P or N > MAX_N:
        raise ValueError(f"chunk {chunk}, P {P}, N {N}: the kernel takes chunk <= {MAX_CHUNK}, "
                         f"P <= {MAX_P}, N <= {MAX_N}")
    x, B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C))
    y = _output(x, out_dtype)
    s_final = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 18)(
        *(st for t in (x, B, C, dt, loga, y) for st in t.stride()[:3])
    )
    with torch.cuda.device(x.device):
        err = _fn()(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(), loga.data_ptr(),
            y.data_ptr(), s_final.data_ptr(), DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype],
            b, H, s, P, N, chunk, strides, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"SSD chunk-scan kernel launch failed (cudaError {err}) for "
                           f"x {tuple(x.shape)} {x.dtype}, N {N}, chunk {chunk}")
    launches += 1
    return y, s_final
