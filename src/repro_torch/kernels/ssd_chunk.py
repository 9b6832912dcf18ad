"""Wrapper of the CUDA Mamba2 SSD chunk-scan forward kernels
(``csrc/ssd_chunk.cu``).

Counterpart of the reference's Pallas ``kernels/ssd_chunk.py``, with its
public layout: ``x (b, H, s, P)``, ``B/C (b, H, s, N)``, ``dt/loga (b, H, s)``
-> ``(y (b, H, s, P), S_final (b, H, P, N) fp32)``, ``chunk = min(chunk, s)``
and ``s % chunk == 0``.  The kernels read every tensor through its batch,
head and sequence strides, so the model's ``(b, s, H, P)`` x goes in as a
transposed view and its ``(b, s, N)`` B/C, shared by all heads, as expanded
views with head stride 0; only the last axis of x, B and C must be
contiguous.  ``y`` is allocated in x's layout when x is held sequence-major
(heads inside sequence, as the model holds it), else as ``(b, H, s, P)``.
``y`` is in ``x.dtype`` (the Pallas contract) unless ``out_dtype`` says
otherwise; ``S_final`` is always fp32.

Every host-side choice is made here, in ``ssd_plan``, a pure function of the
tensors' dtypes, shapes, strides and addresses: the route (``"tensor_cores"``
for bf16 at chunk 128, P 64, N 64 with 16-byte-aligned rows, ``"cuda_cores"``
for everything else), the number of sequence segments G, the heads per block,
the grid and the shared memory.  The C entry point validates the plan.  On
the tensor-core route with G > 1 a call launches two kernels (pass A, the
segments' local states; pass B, the outputs) and the wrapper allocates their
workspace.  ``launches`` counts calls of the scan that reached the card, one
per call whatever the number of kernels it launched.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_P, MAX_N = 128, 64, 64   # the CUDA-core kernel's shared-memory layout
ROUTES = ("cuda_cores", "tensor_cores")   # index = the route's code in the plan
PLAN_LEN = 9

N_SM = 132                  # streaming multiprocessors of an H100 SXM
SM_SMEM = 233472            # shared memory of one SM (228 KB); each block reserves 1 KB more
SM_THREADS = 2048
CORE_THREADS = 256
CORE_SMEM = 4 * (128 * 64 + 2 * 128 * 65 + 128 * 129 + 64 * 65 + 4 * 128)
TC_CHUNK, TC_P, TC_N = 128, 64, 64   # the only shape the tensor-core kernel is built for
TC_LD = 72                  # bf16 row stride of its shared-memory operands
TC_S_TERMS = 3              # bf16 terms S is split into for C S^T (``TERMS_S``)
MAX_SEGMENTS = 64
# The segment count's cost model, in chunk-times of pass B: a block's fixed
# cost (the first chunk's load, the prologue) and the cost of a chunk in pass
# A (the state product only) -- estimates from the kernels' operation counts.
SEGMENT_FILL = 1.0
STATE_ONLY_COST = 0.3

launches = 0


def tc_smem(heads_per_block: int, state_only: bool) -> int:
    """Dynamic shared memory of the tensor-core kernel (``TcLayout``): two
    stages of x (per head), B, C (pass B), dt and loga (per head, fp32), then
    S's bf16 terms per head (pass B)."""
    tile = TC_CHUNK * TC_LD * 2
    stage = heads_per_block * tile + tile + (0 if state_only else tile) \
        + 2 * heads_per_block * TC_CHUNK * 4
    s_split = 0 if state_only else TC_S_TERMS * heads_per_block * TC_P * TC_LD * 2
    return 2 * stage + s_split


def blocks_per_sm(threads: int, smem: int) -> int:
    return max(1, min(SM_THREADS // threads, SM_SMEM // (smem + 1024)))


def segments_for(units: int, n_chunks: int, slots_b: int, slots_a: int) -> int:
    """G for ``units`` = b * H / HB blocks per segment index: 1 where those
    already fill the card, else the G of least estimated time, waves of pass
    B times its longest segment plus the same for pass A."""
    if units >= slots_b:
        return 1
    best = (math.inf, 1)
    for g in range(1, min(n_chunks, MAX_SEGMENTS) + 1):
        seg = -(-n_chunks // g)
        t = -(-units * g // slots_b) * (seg + SEGMENT_FILL)
        if g > 1:
            t += -(-units * (g - 1) // slots_a) * (STATE_ONLY_COST * seg + SEGMENT_FILL)
        best = min(best, (t, g))
    return best[1]


@dataclasses.dataclass(frozen=True)
class SSDPlan:
    route: str
    heads_per_block: int
    segments: int
    threads: int
    grid: tuple[int, int, int]     # pass B's (the CUDA-core kernel's: (H, b, 1))
    smem_bytes: int
    state_smem_bytes: int = 0      # pass A's; 0 where there is no pass A

    def as_array(self):
        """The int64 layout the C entry point reads (the launch plan in the source)."""
        values = [ROUTES.index(self.route), self.heads_per_block, self.segments, self.threads,
                  *self.grid, self.smem_bytes, self.state_smem_bytes]
        return (ctypes.c_longlong * PLAN_LEN)(*values)


def tc_aligned(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, y: torch.Tensor) -> bool:
    """16-byte-aligned base addresses, batch/head/sequence strides of x, B, C
    a multiple of 8 elements (16 bytes of bf16) and y's even."""
    return (all(t.data_ptr() % 16 == 0 for t in (x, B, C, y))
            and all(st % 8 == 0 for t in (x, B, C) for st in t.stride()[:3])
            and all(st % 2 == 0 for st in y.stride()[:3]))


def ssd_plan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, chunk: int,
             y: torch.Tensor) -> SSDPlan:
    """The launch of ``ssd_chunk_scan_fwd`` for these tensors (``chunk`` the
    one used, ``min(chunk, s)``; ``y`` the output the wrapper allocated; dt and
    loga, fp32, take no part in the choice).  Pure: reads dtypes, shapes,
    strides and addresses only, so it runs on CPU and meta tensors too."""
    b, H, s, P = x.shape
    N = B.shape[-1]
    if (x.dtype == B.dtype == C.dtype == torch.bfloat16 and (chunk, P, N) == (TC_CHUNK, TC_P, TC_N)
            and tc_aligned(x, B, C, y)):
        shared = H % 2 == 0 and B.stride(1) == 0 and C.stride(1) == 0
        hb = 2 if shared else 1
        threads = 128 * hb
        smem_b, smem_a = tc_smem(hb, False), tc_smem(hb, True)
        g = segments_for(b * H // hb, s // chunk, N_SM * blocks_per_sm(threads, smem_b),
                         N_SM * blocks_per_sm(threads, smem_a))
        return SSDPlan("tensor_cores", hb, g, threads, (g, H // hb, b), smem_b,
                       smem_a if g > 1 else 0)
    return SSDPlan("cuda_cores", 1, 1, CORE_THREADS, (H, b, 1), CORE_SMEM)


@functools.cache
def _fn():
    fn = _build.load("ssd_chunk").ssd_chunk_scan_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x B C
        ctypes.c_void_p, ctypes.c_void_p,                    # dt loga
        ctypes.c_void_p, ctypes.c_void_p,                    # y S_final
        ctypes.c_void_p, ctypes.c_void_p,                    # S_loc, D (workspace)
        ctypes.c_int, ctypes.c_int,                          # dtype codes: in, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # b H s
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # P N chunk
        ctypes.POINTER(ctypes.c_longlong),                   # strides
        ctypes.POINTER(ctypes.c_longlong),                   # plan
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
    plan = ssd_plan(x, B, C, chunk, y)
    s_loc = decay = None
    if plan.segments > 1:   # pass A's output: each segment's local state and decay
        s_loc = torch.empty((b, H, plan.segments - 1, P, N), dtype=torch.float32, device=x.device)
        decay = torch.empty((b, H, plan.segments - 1), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 18)(
        *(st for t in (x, B, C, dt, loga, y) for st in t.stride()[:3])
    )
    with torch.cuda.device(x.device):
        err = _fn()(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(), loga.data_ptr(),
            y.data_ptr(), s_final.data_ptr(), s_loc.data_ptr() if s_loc is not None else None,
            decay.data_ptr() if decay is not None else None,
            DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype], b, H, s, P, N, chunk, strides,
            plan.as_array(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"SSD chunk-scan kernel ({plan.route}) launch failed (cudaError {err}) "
                           f"for x {tuple(x.shape)} {x.dtype}, N {N}, chunk {chunk}")
    launches += 1
    return y, s_final
