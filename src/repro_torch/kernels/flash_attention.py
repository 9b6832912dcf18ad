"""Wrappers of the CUDA flash-attention kernels (``csrc/flash_attention.cu``):
the forward, which can also write each row's log-sum-exp, and the backward.

Counterpart of the reference's Pallas ``kernels/flash_attention.py``, with its
public layout: ``q (b, hq, sq, hd)``, ``k/v (b, hkv, skv, hd)`` ->
``(b, hq, sq, hd)``.  The kernels read each tensor through its batch, head and
sequence strides, so the model's ``(b, s, h, hd)`` tensors go in as transposed
views without a copy; only the ``hd`` axis must be contiguous.  The output is
allocated with ``q``'s memory layout.

Every host-side choice is made here, in ``flash_plan``, a pure function of the
tensors' dtypes, shapes, strides and addresses: the route (``"wgmma"`` for bf16
whose rows are 16-byte aligned, ``"cuda_cores"`` for everything else), the
tile sizes, stages, grid and dynamic shared memory, for the ``wgmma`` route each
operand's 4-D tensor map (dims, byte strides, boxes, head-dim slabs and their
swizzle), and for the CUDA cores whether rows move by 16-byte ``cp.async``
(``vector_loads``: fp32 in 16-byte pieces) or element by element.  The C
entry point validates the plan against the kernel it built and encodes the
tensor maps.  ``launches`` counts kernel launches.

The backward (``flash_attention_bwd_cuda``: dq, dk, dv from q, k, v, the
forward's out and lse, and dout) is a dK/dV and a dQ kernel, each
recomputing P from lse, and D = rowsum(dO * O).  The training forward of bf16
also writes ``out_res``, what rounding out to bf16 dropped, and the backward's
D reads ``out + out_res``: D from the rounded out alone errs by 2^-9 of |dO| |O|,
which dS = P (dP - D) takes whole where a row's keys or values share a large
common part (near-uniform attention over many keys).  bf16 whose rows are 16-byte
aligned takes the ``"wgmma"`` route (TMA, warp specialisation; the dQ kernel
runs first and also computes D; a GQA group's query heads split over
``splits`` dK/dV blocks when the kv heads alone would leave SMs idle, with a
third kernel summing the splits' fp32 partials in order); everything else
runs on the CUDA cores, where the dQ kernel also computes D and a GQA
group splits the same way.  ``flash_bwd_plan`` fixes
its route, tiles, grids, shared memory, splits, workspaces and tensor maps,
and ``bwd_launches`` counts its calls.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
ROUTES = ("cuda_cores", "wgmma")   # index = the route's code in the plan

SMEM_LIMIT = 232448             # dynamic shared memory a block may opt into
WGMMA_BM = 128                  # query rows per block: two consumer warpgroups of 64
WGMMA_THREADS = 384             # the two consumer warpgroups and the producer
WGMMA_BN = 128                  # keys per K/V tile
WGMMA_STAGES = 3                # K/V tiles in flight
CORE_ROWS, CORE_THREADS = 64, 128  # CUDA cores: rows a block owns; 16 x 8 threads
ENCODE_FAILED = 10000           # the C side's code for a failed tensor-map encode
PLAN_LEN = 9 + 3 * 16
BWD_ROUTES = ("cuda_cores", "wgmma")  # index = the route's code in the plan
BWD_ROWS = {"cuda_cores": CORE_ROWS, "wgmma": 128}   # queries (dQ) or keys (dK/dV) a block owns
BWD_THREADS = {"cuda_cores": CORE_THREADS, "wgmma": 384}   # 16 x 8 micro-tiles; two consumer
                                                           # warpgroups and the producer
BWD_STAGES = 3                  # walked tiles in flight on the wgmma route
BWD_PLAN_LEN = 18 + 8 * 16      # plan values, then 8 tensor maps
SMS = 132                       # the H100's streaming multiprocessors

launches = 0
bwd_launches = 0


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
    vector_loads: bool = False         # CUDA cores: every row moves by 16-byte cp.async

    def as_array(self):
        """The int64 layout the C entry point reads (see ``PLAN_OPERANDS``
        in the source); on the CUDA cores ``vector_loads`` takes the first
        map's place."""
        values = [ROUTES.index(self.route), self.bm, self.bn, self.stages, self.threads,
                  *self.grid, self.smem_bytes]
        for m in self.maps:
            values += m.values()
        if self.route == "cuda_cores":
            values.append(int(self.vector_loads))
        values += [0] * (PLAN_LEN - len(values))
        return (ctypes.c_longlong * PLAN_LEN)(*values)


def head_dim_slabs(hd: int) -> tuple[tuple[int, int, int], ...]:
    """The head dim in slabs of at most 64 columns, each with the widest
    swizzle its row takes (2 bytes a column): 80 -> 64 + 16, 96 -> 64 + 32,
    128 -> 64 + 64."""
    widths = (64, hd - 64) if hd > 64 else (hd,)
    return tuple((64 * i, w, 2 * w) for i, w in enumerate(widths))


def rows_16_byte_aligned(tensors) -> bool:
    """Every base address 16-byte aligned and every batch/head/sequence
    stride a multiple of 8 elements (the wgmma route's rule for bf16)."""
    return all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])
               for t in tensors)


def core_row_stride(hd: int) -> int:
    """fp32 row stride (floats) of a CUDA-core operand tile: hd + 4, an odd
    number of 16-byte groups, so that 16-byte reads of 8 consecutive rows at
    one column hit 8 distinct groups of 4 banks."""
    return hd + 4


def core_p_stride(cols: int) -> int:
    """Row stride of the (64, cols) P / dS tile: cols + 8, 8 banks mod 32, so
    that a warp's 4 rows x 8 columns of scalar stores hit 32 distinct banks and
    its 4 rows' 16-byte reads hit groups 0, 2, 4 and 6."""
    return cols + 8


def core_vector_loads(tensors) -> bool:
    """fp32 rows that 16-byte ``cp.async`` copies and vector stores take:
    every base 16-byte aligned, every batch/head/sequence stride a multiple
    of 4 elements.  Everything else (all bf16 here) moves element by element."""
    return all(t.dtype == torch.float32 and t.data_ptr() % 16 == 0
               and all(s % 4 == 0 for s in t.stride()[:3]) for t in tensors)


def core_fwd_layout(hd: int) -> tuple[int, int, int]:
    """(keys a walked K/V tile holds, stages, shared bytes) of the CUDA-core
    forward: the owned Q tile, ``stages`` K and V tiles in flight and the P
    tile, fp32 rows.  64 keys up to hd 64, 32 beyond, so that two blocks fit an SM."""
    cols, stages = (64 if hd <= 64 else 32), 2
    rs = core_row_stride(hd)
    floats = CORE_ROWS * rs + stages * 2 * cols * rs + CORE_ROWS * core_p_stride(cols)
    return cols, stages, 4 * floats


def core_bwd_layout(hd: int) -> tuple[int, int, int, int]:
    """(walked rows, stages, dK/dV shared bytes, dQ shared bytes) of the
    CUDA-core backward: tiles of 32 walked rows, 3 stages up to hd 64 (2
    beyond) so that two blocks fit an SM up to hd 96.  dK/dV: owned K and V,
    then per stage Q, dO and their lse and D; dQ: owned Q and dO, then per
    stage K and V; both end with the P / dS tile."""
    cols, stages = 32, (3 if hd <= 64 else 2)
    rs, tail = core_row_stride(hd), CORE_ROWS * core_p_stride(cols)
    own = 2 * CORE_ROWS * rs
    dkv = own + stages * (2 * cols * rs + 2 * cols) + tail
    dq = own + stages * 2 * cols * rs + tail
    return cols, stages, 4 * dkv, 4 * dq


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
    bn, stages, smem = core_fwd_layout(hd)
    return FlashPlan(route="cuda_cores", bm=CORE_ROWS, bn=bn, stages=stages,
                     threads=CORE_THREADS, grid=(-(-sq // CORE_ROWS), hq, b), smem_bytes=smem,
                     vector_loads=core_vector_loads((q, k, v, out)))


@dataclasses.dataclass(frozen=True)
class FlashBwdPlan:
    route: str
    rows: int                        # queries (dQ) or keys (dK/dV) a block owns
    cols: int                        # queries of a tile the dK/dV kernel walks
    cols_dq: int                     # keys of a tile the dQ kernel walks
    stages: int                      # walked tiles in flight (1: loaded in place)
    threads: int
    # the work: one item a block, or (wgmma) the items a persistent grid of a
    # block an SM walks
    grid_dq: tuple[int, int, int]    # (query tiles, q heads, batch)
    grid_dkv: tuple[int, int, int]   # (key tiles, kv heads x splits, batch)
    smem_bytes: int                  # the dK/dV kernel's dynamic shared memory
    smem_dq_bytes: int               # the dQ kernel's
    dot_blocks: int                  # blocks of the D pass (wgmma: 0, the dQ kernel's work)
    splits: int                      # dK/dV blocks sharing a kv head's query heads
    sq_pad: int                      # row stride of the D (and lse) workspace
    stats_floats: int                # that workspace's fp32 values (wgmma: lse2, then D)
    workspace_bytes: int             # the splits' fp32 partial dK/dV (0: none)
    maps: tuple[TensorMap, ...] = ()  # wgmma: dK/dV's k, v, q, dout; dQ's q, dout, k, v
    vector_loads: bool = False        # CUDA cores: every row moves by 16-byte cp.async

    def as_array(self):
        """The int64 layout the C entry point reads (``BWD_PLAN_LEN``); on
        the CUDA cores ``vector_loads`` takes the first map's place."""
        values = [BWD_ROUTES.index(self.route), self.rows, self.cols, self.cols_dq, self.stages,
                  self.threads, *self.grid_dq, *self.grid_dkv, self.smem_bytes,
                  self.smem_dq_bytes, self.dot_blocks, self.splits, self.sq_pad,
                  self.workspace_bytes]
        for m in self.maps:
            values += m.values()
        if self.route == "cuda_cores":
            values.append(int(self.vector_loads))
        values += [0] * (BWD_PLAN_LEN - len(values))
        return (ctypes.c_longlong * BWD_PLAN_LEN)(*values)


def bwd_cols(hd: int) -> tuple[int, int]:
    """Rows of a tile the wgmma dK/dV and dQ kernels walk: 64 queries (32 at
    hd 128) and 64 keys.  A thread has 168 registers (384 a block) for S, dP,
    bf16 P and dS and the fp32 accumulators: dK and dV at hd 128 take 128.
    At hd 96 (96 of them) 64 queries still fit (ptxas: no spill) and beat 32
    on an H100 (0.569 against 0.625 ms at phi-3-vision's (4, 32, 1600, 96))."""
    return 32 if hd >= 128 else 64, 64


def bwd_wgmma_smem(hd: int, cols: int, with_stats: bool) -> int:
    """1024 bytes to align the base, two buffers of the two owned (128, hd)
    bf16 tensors (a persistent block loads its next item's while it computes
    one), then ``BWD_STAGES`` stages of two walked (cols, hd) tensors (and
    their lse and D), each stage rounded up to 1024 bytes (the swizzle's
    period)."""
    loaded = 2 * cols * hd * 2 + (2 * cols * 4 if with_stats else 0)
    return 1024 + 2 * 2 * BWD_ROWS["wgmma"] * hd * 2 + BWD_STAGES * (-(-loaded // 1024) * 1024)


def gqa_splits(group: int, blocks: int) -> int:
    """The fewest splits of a GQA group's query heads (a divisor of the
    group) that give every SM a dK/dV block, or the whole group."""
    return next((d for d in range(1, group + 1) if group % d == 0 and blocks * d >= SMS), group)


def flash_bwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                   dout: torch.Tensor, dq: torch.Tensor, dk: torch.Tensor,
                   dv: torch.Tensor) -> FlashBwdPlan:
    """The launch of ``flash_attention_bwd`` for q (b, hq, sq, hd), k/v (b,
    hkv, skv, hd), the forward's out, dout and the gradients it writes.  Pure:
    reads dtypes, shapes, strides and addresses only."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16 and rows_16_byte_aligned((q, k, v, out, dout, dq, dk, dv)):
        rows, (cols, cols_dq) = BWD_ROWS["wgmma"], bwd_cols(hd)
        key_tiles = -(-skv // rows)
        splits = gqa_splits(hq // hkv, key_tiles * hkv * b)
        sq_pad = -(-sq // rows) * rows
        return FlashBwdPlan(
            route="wgmma", rows=rows, cols=cols, cols_dq=cols_dq, stages=BWD_STAGES,
            threads=BWD_THREADS["wgmma"], grid_dq=(-(-sq // rows), hq, b),
            grid_dkv=(key_tiles, hkv * splits, b), smem_bytes=bwd_wgmma_smem(hd, cols, True),
            smem_dq_bytes=bwd_wgmma_smem(hd, cols_dq, False),
            dot_blocks=0, splits=splits, sq_pad=sq_pad,
            stats_floats=2 * b * hq * sq_pad,
            workspace_bytes=2 * splits * b * hkv * skv * hd * 4 if splits > 1 else 0,
            maps=(_tensor_map(k, rows), _tensor_map(v, rows), _tensor_map(q, cols),
                  _tensor_map(dout, cols), _tensor_map(q, rows), _tensor_map(dout, rows),
                  _tensor_map(k, cols_dq), _tensor_map(v, cols_dq)),
        )
    # the CUDA cores: 64 owned rows a block, 32-row walked tiles; a GQA group
    # splits as on wgmma, D and lse go to a workspace padded to the owned rows
    rows = BWD_ROWS["cuda_cores"]
    cols, stages, smem, smem_dq = core_bwd_layout(hd)
    key_tiles = -(-skv // rows)
    splits = gqa_splits(hq // hkv, key_tiles * hkv * b)
    sq_pad = -(-sq // rows) * rows
    return FlashBwdPlan(
        route="cuda_cores", rows=rows, cols=cols, cols_dq=cols, stages=stages,
        threads=BWD_THREADS["cuda_cores"], grid_dq=(-(-sq // rows), hq, b),
        grid_dkv=(key_tiles, hkv * splits, b), smem_bytes=smem, smem_dq_bytes=smem_dq,
        dot_blocks=0, splits=splits, sq_pad=sq_pad, stats_floats=2 * b * hq * sq_pad,
        workspace_bytes=2 * splits * b * hkv * skv * hd * 4 if splits > 1 else 0,
        vector_loads=core_vector_loads((q, k, v, out, dout, dq, dk, dv)),
    )


@functools.cache
def _fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q k v o
        ctypes.c_void_p,                                                     # lse or null
        ctypes.c_void_p,                                                     # o's residual or null
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


def _check_cuda(what: str, tensors, causal: bool) -> None:
    """The device, dtype and head-dim rules of the forward and backward
    kernels (``tensors`` start with q, k, v)."""
    q, k, v = tensors[:3]
    check_shapes(q, k, v, causal)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{what} needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if q.dtype not in DTYPE_CODES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{what} takes float32/bfloat16 of one type, got "
                        f"{[t.dtype for t in tensors]}")
    b, hq, sq, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not built; the kernel has {HEAD_DIMS}")
    if min(b, hq, sq, k.shape[2]) < 1:
        raise ValueError(f"empty attention problem: q {tuple(q.shape)}, k {tuple(k.shape)}")


def _describe(err: int) -> str:
    """A C entry point's error code in words."""
    if err >= ENCODE_FAILED:
        return f"tensor-map encode failed (CUresult {err - ENCODE_FAILED})"
    return f"cudaError {err}"


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, with_lse: bool = False):
    """out (b, hq, sq, hd) in q's dtype and memory layout; with ``with_lse``,
    ``(out, lse, out_res)`` with lse the (b, hq, sq) fp32 log-sum-exp the
    backward takes and, for bf16, ``out_res`` (out's dtype and strides) what
    rounding out dropped, also for the backward (None for fp32, whose out is
    not rounded).  Storing lse and out_res leaves out's rounding as it is."""
    global launches
    _check_cuda("flash_attention_cuda", (q, k, v), causal)
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = _dense_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device) if with_lse else None
    out_res = torch.empty_like(out) if with_lse and q.dtype != torch.float32 else None
    plan = flash_plan(q, k, v, out)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3])
    )
    with torch.cuda.device(q.device):
        err = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if out_res is None else out_res.data_ptr(),
            DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv, hd, strides,
            1.0 / math.sqrt(hd), int(causal), plan.as_array(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel ({plan.route}) launch failed "
                           f"({_describe(err)}) for q {tuple(q.shape)}, k {tuple(k.shape)} {q.dtype}")
    launches += 1
    return (out, lse, out_res) if with_lse else out


@functools.cache
def _bwd_fn():
    fn = _build.load("flash_attention").flash_attention_bwd
    fn.argtypes = [
        *[ctypes.c_void_p] * 6,                   # q k v o, o's residual or null, dout
        ctypes.c_void_p, ctypes.c_void_p,         # lse, the D workspace
        ctypes.c_void_p,                          # the partial dK/dV workspace or null
        *[ctypes.c_void_p] * 3,                   # dq dk dv
        ctypes.c_int,                             # dtype
        *[ctypes.c_int] * 6,                      # b hq hkv sq skv hd
        ctypes.POINTER(ctypes.c_longlong),        # strides
        ctypes.c_float, ctypes.c_int,             # scale causal
        ctypes.POINTER(ctypes.c_longlong),        # plan
        ctypes.c_void_p,                          # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True, out_res: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), each in its input's shape, dtype and memory layout, from
    the forward's out, lse and (bf16) out_res (``flash_attention_cuda(...,
    with_lse=True)``) and the gradient ``dout`` of out.  Any tensor whose head
    dim is contiguous is read through its strides (dout may be a transposed
    view)."""
    global bwd_launches
    _check_cuda("flash_attention_bwd_cuda", (q, k, v, out, dout) + (
        () if out_res is None else (out_res,)), causal)
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must have q's "
                         f"shape {tuple(q.shape)}")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be (b, hq, sq) = {(b, hq, sq)} float32 on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    if out_res is not None and (out_res.shape != out.shape or out_res.stride() != out.stride()):
        raise ValueError(f"out_res {tuple(out_res.shape)} {out_res.stride()} must have out's "
                         f"shape and strides {tuple(out.shape)} {out.stride()}")
    q, k, v, dout = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v, dout))
    if out.stride(-1) != 1:
        out, out_res = (None if t is None else t.contiguous() for t in (out, out_res))
    lse = lse.contiguous()
    dq, dk, dv = _dense_like(q), _dense_like(k), _dense_like(v)
    plan = flash_bwd_plan(q, k, v, out, dout, dq, dk, dv)
    delta = torch.empty(plan.stats_floats, dtype=torch.float32, device=q.device)
    workspace = (torch.empty(plan.workspace_bytes // 4, dtype=torch.float32, device=q.device)
                 if plan.workspace_bytes else None)
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3])
    )
    with torch.cuda.device(q.device):
        err = _bwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if out_res is None else out_res.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), None if workspace is None else workspace.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            DTYPE_CODES[q.dtype], b, hq, hkv, sq, skv, hd, strides,
            1.0 / math.sqrt(hd), int(causal), plan.as_array(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention backward ({plan.route}) launch failed "
                           f"({_describe(err)}) for q {tuple(q.shape)}, k {tuple(k.shape)} {q.dtype}")
    bwd_launches += 1
    return dq, dk, dv
