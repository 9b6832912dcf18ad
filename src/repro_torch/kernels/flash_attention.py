"""Wrapper of the CUDA flash-attention forward kernels
(``csrc/flash_attention.cu``).

Counterpart of the reference's Pallas ``kernels/flash_attention.py``, with its
public layout: ``q (b, hq, sq, hd)``, ``k/v (b, hkv, skv, hd)`` ->
``(b, hq, sq, hd)``.  The kernels read each tensor through its batch, head and
sequence strides, so the model's ``(b, s, h, hd)`` tensors go in as transposed
views without a copy; only the ``hd`` axis must be contiguous.  The output is
allocated with ``q``'s memory layout.

Every host-side choice is made here, in ``flash_plan``, a pure function of the
tensors' dtypes, shapes, strides and addresses: the route (``"wgmma"`` for bf16
whose rows are 16-byte aligned, ``"cuda_cores"`` for everything else), the
tile sizes, grid and dynamic shared memory, and for the ``wgmma`` route each
operand's 4-D tensor map (dims, byte strides, boxes, head-dim slabs and their
swizzle).  The C entry point validates the plan against the kernel it built
and encodes the tensor maps.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128)
ROUTES = ("cuda_cores", "wgmma")   # index = the route's code in the plan

SMEM_LIMIT = 232448             # dynamic shared memory a block may opt into
WGMMA_BM = 128                  # query rows per block: two consumer warpgroups of 64
WGMMA_THREADS = 384             # the two consumer warpgroups and the producer
WGMMA_BN = 128                  # keys per K/V tile
WGMMA_STAGES = 3                # K/V tiles in flight
CORE_BM, CORE_THREADS = 64, 256  # the CUDA-core kernel's query tile and block
ENCODE_FAILED = 10000           # the C side's code for a failed tensor-map encode
PLAN_LEN = 9 + 3 * 16

launches = 0


@dataclasses.dataclass(frozen=True)
class TensorMap:
    """One operand's 4-D TMA map: ``dims`` (hd, s, h, b) innermost first,
    ``strides`` the byte strides of s, h and b, and one box per head-dim slab
    ``(first column, width, swizzle bytes)`` of ``box_rows`` rows."""

    dims: tuple[int, int, int, int]
    strides: tuple[int, int, int]
    slabs: tuple[tuple[int, int, int], ...]
    box_rows: int

    def values(self) -> list[int]:
        slabs = [x for col, width, swz in self.slabs for x in (col, width, swz, self.box_rows)]
        return [*self.dims, *self.strides, len(self.slabs), *slabs, *[0] * (8 - len(slabs))]


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    route: str
    bm: int
    bn: int
    stages: int
    threads: int
    grid: tuple[int, int, int]
    smem_bytes: int
    maps: tuple[TensorMap, ...] = ()   # q, k, v on the wgmma route

    def as_array(self):
        """The int64 layout the C entry point reads (see ``PLAN_OPERANDS``
        in the source)."""
        values = [ROUTES.index(self.route), self.bm, self.bn, self.stages, self.threads,
                  *self.grid, self.smem_bytes]
        for m in self.maps:
            values += m.values()
        values += [0] * (PLAN_LEN - len(values))
        return (ctypes.c_longlong * PLAN_LEN)(*values)


def head_dim_slabs(hd: int) -> tuple[tuple[int, int, int], ...]:
    """The head dim in slabs of at most 64 columns, each with the widest
    swizzle its row takes (2 bytes a column): 80 -> 64 + 16, 128 -> 64 + 64."""
    widths = (64, hd - 64) if hd > 64 else (hd,)
    return tuple((64 * i, w, 2 * w) for i, w in enumerate(widths))


def rows_16_byte_aligned(tensors) -> bool:
    """Every base address 16-byte aligned and every batch/head/sequence
    stride a multiple of 8 elements (the wgmma route's rule for bf16)."""
    return all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
               for t in tensors)


def _tensor_map(t: torch.Tensor, box_rows: int) -> TensorMap:
    b, h, s, hd = t.shape
    item = t.element_size()
    # a dimension of size 1 is only ever read at 0: give it the stride of a
    # contiguous (b, h, s, hd) tensor, so that any stride torch reports for it will do
    dense = (h * s * hd * item, s * hd * item, hd * item)
    strides = tuple(st * item if n > 1 else d
                    for st, n, d in zip(t.stride()[:3], (b, h, s), dense))
    return TensorMap(dims=(hd, s, h, b), strides=(strides[2], strides[1], strides[0]),
                     slabs=head_dim_slabs(hd), box_rows=box_rows)


def flash_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor) -> FlashPlan:
    """The launch of ``flash_attention_fwd`` for these tensors (logical
    ``(b, h, s, hd)``, hd contiguous).  Pure: reads dtypes, shapes, strides
    and addresses only, so it runs on CPU tensors too."""
    b, hq, sq, hd = q.shape
    if q.dtype == torch.bfloat16 and rows_16_byte_aligned((q, k, v, out)):
        return FlashPlan(
            route="wgmma", bm=WGMMA_BM, bn=WGMMA_BN, stages=WGMMA_STAGES, threads=WGMMA_THREADS,
            grid=(-(-sq // WGMMA_BM), hq, b),
            smem_bytes=1024 + WGMMA_BM * hd * 2 + WGMMA_STAGES * 2 * WGMMA_BN * hd * 2,
            maps=(_tensor_map(q, WGMMA_BM), _tensor_map(k, WGMMA_BN), _tensor_map(v, WGMMA_BN)),
        )
    bn = 32 if hd >= 128 else 64
    floats = CORE_BM * (hd + 4) + bn * (hd + 4) + bn * hd + CORE_BM * (bn + 4)
    return FlashPlan(route="cuda_cores", bm=CORE_BM, bn=bn, stages=1, threads=CORE_THREADS,
                     grid=(-(-sq // CORE_BM), hq, b), smem_bytes=4 * floats)


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
        ctypes.POINTER(ctypes.c_longlong),                                   # plan
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
    plan = flash_plan(q, k, v, out)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3])
    )
    with torch.cuda.device(q.device):
        err = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv, hd, strides,
            1.0 / math.sqrt(hd), int(causal), plan.as_array(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        what = (f"tensor-map encode failed (CUresult {err - ENCODE_FAILED})"
                if err >= ENCODE_FAILED else f"cudaError {err}")
        raise RuntimeError(f"flash attention kernel ({plan.route}) launch failed ({what}) for "
                           f"q {tuple(q.shape)}, k {tuple(k.shape)} {q.dtype}")
    launches += 1
    return out
