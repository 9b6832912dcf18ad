"""Wrapper of the CUDA flash-attention forward kernel
(``csrc/flash_attention.cu``).

Counterpart of the reference's Pallas ``kernels/flash_attention.py``, with its
public layout: ``q (b, hq, sq, hd)``, ``k/v (b, hkv, skv, hd)`` ->
``(b, hq, sq, hd)``.  The kernel reads each tensor through its batch, head and
sequence strides, so the model's ``(b, s, h, hd)`` tensors go in as transposed
views without a copy; only the ``hd`` axis must be contiguous.  The output is
allocated with ``q``'s memory layout.  The launcher in the ``.cu`` file picks
the tensor-core kernel for bf16 tensors whose rows are 16-byte aligned and the
fp32 CUDA-core kernel for everything else.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)

launches = 0


@functools.cache
def _fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v o
        ctypes.c_int,                                                        # dtype
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                            # b hq hkv
        ctypes.c_int, ctypes.c_int, ctypes.c_int,                            # sq skv hd
        ctypes.POINTER(ctypes.c_longlong),                                   # strides
        ctypes.c_float, ctypes.c_int,                                        # scale causal
        ctypes.c_void_p,                                                     # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    """Shape rules shared by the kernel and its plain version."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (b,hq,sq,hd), k/v (b,hkv,skv,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"batch/head_dim of q {tuple(q.shape)} and k {tuple(k.shape)} differ")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"hq={q.shape[1]} is not a multiple of hkv={k.shape[1]}")
    if causal and q.shape[2] > k.shape[2]:
        # The reference's kernel averages v over such fully masked rows while
        # its own oracle gives NaN; neither is a result to serve.
        raise ValueError(
            f"causal attention with sq={q.shape[2]} > skv={k.shape[2]} leaves rows with no "
            "visible key; the reference is undefined there"
        )


def _dense_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of t's shape, in t's memory layout when that
    layout is a permutation of a contiguous one."""
    out = torch.empty_like(t)
    return out if out.stride(-1) == 1 else torch.empty(t.shape, dtype=t.dtype, device=t.device)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    global launches
    check_shapes(q, k, v, causal)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention_cuda needs CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda takes float32/bfloat16 of one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not built; the kernel has {HEAD_DIMS}")
    if min(b, hq, sq, skv) < 1:
        raise ValueError(f"empty attention problem: q {tuple(q.shape)}, k {tuple(k.shape)}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = _dense_like(q)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3])
    )
    with torch.cuda.device(q.device):
        err = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv, hd, strides,
            1.0 / math.sqrt(hd), int(causal),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed (cudaError {err}) for "
                           f"q {tuple(q.shape)}, k {tuple(k.shape)} {q.dtype}")
    launches += 1
    return out
