"""Wrappers of the CUDA Mamba2 SSD chunk-scan kernels: the forward
(``csrc/ssd_chunk.cu``) and its backward (``csrc/ssd_chunk_bwd.cu``).

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

The backward (``ssd_chunk_scan_bwd_cuda``, planned by ``ssd_bwd_plan``) takes
B and C either per head, ``(b, H, s, N)``, or as ``(b, s, N)`` shared by the
heads, and then returns their gradient summed over the heads, ``(b, s, N)``.
It has the forward's two routes.  On the tensor cores (bf16 x/B/C at chunk
128, P 64, N 64, 16-byte-aligned rows of x, B, C and dy) it runs four kernels:
every chunk's local state and state gradient at once, their composition into
each chunk's incoming state and outgoing state gradient, every chunk at once
a group of heads a block, and the ordered sum of the groups' dB/dC partials.
On the CUDA cores three: the states walked chunk by chunk, the chunks, the
sum.  Workspaces are allocated here.  ``bwd_launches`` counts its calls that
reached the card.
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
bwd_launches = 0

# The backward (``csrc/ssd_chunk_bwd.cu``): its chunk kernel has 256 threads a
# block on both routes and one block an SM by shared memory.  A block's fixed
# cost beside one head's, in head-times, estimated from the kernels' operation
# counts: on the CUDA cores its B/C staging and its two chunk x chunk dB/dC
# products; on the tensor cores its B/C staging, C B^T and the dB/dC products
# with dcb in three terms (about 2 000 mma a block against 5 700 a head).
BWD_THREADS = 256
BWD_STATES_SMEM = 4 * (2 * 128 * 64 + 2 * 128)
BWD_CHUNK_SMEM = 4 * (128 * 65 + 128 * 64 + 128 * 65 + 128 * 64 + 128 * 129 + 8 * 128
                      + 2 * 8 * 128 + 8)
BWD_BLOCK_COST = 0.6
BWD_TC_BLOCK_COST = 0.4
BWD_TERMS = 3               # bf16 terms of each fp32 operand on the tensor cores (``TERMS``)
BWD_PLAN_LEN = 9
REDUCE_BLOCKS_MAX = 4 * N_SM


def tc_smem(heads_per_block: int, state_only: bool) -> int:
    """Dynamic shared memory of the tensor-core kernel (``TcLayout``): two
    stages of x (per head), B, C (pass B), dt and loga (per head, fp32), then
    S's bf16 terms per head (pass B)."""
    tile = TC_CHUNK * TC_LD * 2
    stage = heads_per_block * tile + tile + (0 if state_only else tile) \
        + 2 * heads_per_block * TC_CHUNK * 4
    s_split = 0 if state_only else TC_S_TERMS * heads_per_block * TC_P * TC_LD * 2
    return 2 * stage + s_split


def bwd_dy_terms(dy_dtype: torch.dtype) -> int:
    """bf16 terms of dy on the backward's tensor-core route: bf16 dy is exact."""
    return 1 if dy_dtype == torch.bfloat16 else BWD_TERMS


def bwd_tc_states_smem(dy_dtype: torch.dtype) -> int:
    """Dynamic shared memory of the backward's tensor-core states kernel
    (``TcStatesLayout``): x and B (bf16), then C and dy (fp32 rows of 68, or
    bf16) in the same place; cum, dt, exp(cum) and exp(cum_L - cum) dt."""
    tile = TC_CHUNK * TC_LD * 2
    dy = TC_CHUNK * 68 * 4 if dy_dtype == torch.float32 else tile
    return tile + max(tile, dy) + 4 * TC_CHUNK * 4


def bwd_tc_chunk_smem(dy_dtype: torch.dtype) -> int:
    """Dynamic shared memory of the backward's tensor-core chunk kernel
    (``TcChunkLayout``): B, C, x, dy's terms (bf16), S_in's or dS's terms, C
    B^T and the group's dcb (fp32, 36 tiles of 16 x 16), then its vectors."""
    tile = TC_CHUNK * TC_LD * 2
    frags = 36 * 16 * 16 * 4
    vectors = 4 * (5 * TC_CHUNK + 8 * TC_CHUNK + 2 * TC_CHUNK + 2 * TC_CHUNK + 8)
    return (3 + bwd_dy_terms(dy_dtype)) * tile + BWD_TERMS * TC_P * TC_LD * 2 + 2 * frags + vectors


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


@dataclasses.dataclass(frozen=True)
class SSDBwdPlan:
    route: str                     # "tensor_cores" or "cuda_cores"
    heads_per_group: int
    groups: int                    # the chunk kernel's grid is (groups, chunks, b)
    threads: int                   # the chunk kernel's
    states_smem_bytes: int         # the states kernel's (each chunk's local states, or the walk)
    chunk_smem_bytes: int
    reduce_blocks: int
    partials_per_head: int         # R: groups summed into each head of dB/dC
    out_heads: int                 # J: 1 where B/C are shared, else H

    def as_array(self):
        """The int64 layout the C entry point reads (the launch plan in the source)."""
        values = [ROUTES.index(self.route), self.heads_per_group, self.groups, self.threads,
                  self.states_smem_bytes, self.chunk_smem_bytes, self.reduce_blocks,
                  self.partials_per_head, self.out_heads]
        return (ctypes.c_longlong * BWD_PLAN_LEN)(*values)


def groups_for(H: int, units: int, slots: int, block_cost: float = BWD_BLOCK_COST) -> int:
    """Head groups of the backward's chunk kernel for ``units`` = b * chunks
    blocks per group: the count of least estimated time, waves of ``slots``
    blocks times a block's heads plus its fixed cost; no group is empty."""
    best = (math.inf, H)
    for g in range(1, H + 1):
        hpg = -(-H // g)
        g_eff = -(-H // hpg)
        t = -(-units * g_eff // slots) * (hpg + block_cost)
        best = min(best, (t, g_eff))
    return best[1]


def bwd_tc_aligned(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor) -> bool:
    """16-byte-aligned base addresses and batch/head/sequence strides of x, B,
    C and dy (B and C as given, or their heads' view)."""
    return (all(t.data_ptr() % 16 == 0 for t in (x, B, C, dy))
            and all(st * t.element_size() % 16 == 0 for t in (x, B, C, dy) for st in t.stride()[:-1]))


def ssd_bwd_plan(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                 chunk: int) -> SSDBwdPlan:
    """The launch of ``ssd_chunk_scan_bwd`` for these inputs (``chunk`` the
    one used; ``B``/``C`` as the caller passed them: ``(b, s, N)`` shared by
    the heads, or ``(b, H, s, N)``).  Pure: reads dtypes, shapes, strides and
    addresses only, so it runs on CPU and meta tensors too."""
    b, H, s, P = x.shape
    N = B.shape[-1]
    units = b * (s // chunk)
    tc = (x.dtype == B.dtype == C.dtype == torch.bfloat16 and dy.dtype in DTYPE_CODES
          and (chunk, P, N) == (TC_CHUNK, TC_P, TC_N) and bwd_tc_aligned(x, B, C, dy))
    if tc:
        route, states_smem, chunk_smem = ("tensor_cores", bwd_tc_states_smem(dy.dtype),
                                          bwd_tc_chunk_smem(dy.dtype))
        cost = BWD_TC_BLOCK_COST
    else:
        route, states_smem, chunk_smem, cost = ("cuda_cores", BWD_STATES_SMEM, BWD_CHUNK_SMEM,
                                                BWD_BLOCK_COST)
    if B.dim() == 3:
        groups = groups_for(H, units, N_SM * blocks_per_sm(BWD_THREADS, chunk_smem), cost)
        hpg = -(-H // groups)
        partials, out_heads = groups, 1
    else:
        groups, hpg, partials, out_heads = H, 1, 1, H
    reduce_blocks = max(1, min(REDUCE_BLOCKS_MAX, -(-b * out_heads * s * N // BWD_THREADS)))
    return SSDBwdPlan(route, hpg, groups, BWD_THREADS, states_smem, chunk_smem, reduce_blocks,
                      partials, out_heads)


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
    """Shape rules shared by the kernels and their plain versions (B and C
    per head, or ``(b, s, N)`` shared by the heads); returns the chunk length
    actually used, ``min(chunk, s)``."""
    if x.dim() != 4 or B.dim() not in (3, 4) or C.shape != B.shape:
        raise ValueError(f"expected x (b,H,s,P), B/C (b,H,s,N) or (b,s,N); got "
                         f"{tuple(x.shape)}, {tuple(B.shape)}, {tuple(C.shape)}")
    b, H, s, _ = x.shape
    heads = (b, s) if B.dim() == 3 else (b, H, s)
    if B.shape[:-1] != heads or dt.shape != (b, H, s) or loga.shape != (b, H, s):
        raise ValueError(f"x {tuple(x.shape)}, B {tuple(B.shape)}, dt {tuple(dt.shape)}, "
                         f"loga {tuple(loga.shape)} do not share (b, H, s)")
    if min(x.shape) < 1 or B.shape[-1] < 1 or chunk < 1:
        raise ValueError(f"empty SSD problem: x {tuple(x.shape)}, B {tuple(B.shape)}, chunk {chunk}")
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of chunk {chunk}; pad first")
    return chunk


def _per_head(t: torch.Tensor, H: int) -> torch.Tensor:
    """B or C as (b, H, s, N): a (b, s, N) tensor, shared by the heads, as a
    head-stride-0 view; a (b, H, s, N) tensor as it is."""
    return t[:, None].expand(-1, H, -1, -1) if t.dim() == 3 else t


def _output(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Uninitialised, of ``t``'s shape -- (b, H, s, ...) -- in ``dtype``, laid
    out as (b, s, H, ...) when ``t`` is held that way (the model's x, y, dt and
    loga)."""
    b, H, s = t.shape[:3]
    if H > 1 and s > 1 and t.stride(1) < t.stride(2):
        return torch.empty((b, s, H, *t.shape[3:]), dtype=dtype, device=t.device).transpose(1, 2)
    return torch.empty(t.shape, dtype=dtype, device=t.device)


def ssd_chunk_scan_cuda(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dt: torch.Tensor,
                        loga: torch.Tensor, chunk: int = 128,
                        out_dtype: torch.dtype | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    chunk = check_shapes(x, B, C, dt, loga, chunk)
    B, C = _per_head(B, x.shape[1]), _per_head(C, x.shape[1])
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


@functools.cache
def _bwd_fn():
    fn = _build.load("ssd_chunk_bwd").ssd_chunk_scan_bwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x B C
        ctypes.c_void_p, ctypes.c_void_p,                    # dt loga
        ctypes.c_void_p, ctypes.c_void_p,                    # dy dS_final
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # dx ddt dloga
        ctypes.c_void_p, ctypes.c_void_p,                    # dB dC
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # S_in, dS, decays (workspace)
        ctypes.c_void_p, ctypes.c_void_p,                    # dB, dC partials (workspace)
        ctypes.c_int, ctypes.c_int,                          # dtype codes: x/B/C, dy
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # b H s
        ctypes.c_int, ctypes.c_int, ctypes.c_int,            # P N chunk
        ctypes.POINTER(ctypes.c_longlong),                   # strides
        ctypes.POINTER(ctypes.c_longlong),                   # plan
        ctypes.c_void_p,                                     # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def ssd_chunk_scan_bwd_cuda(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dt: torch.Tensor,
                            loga: torch.Tensor, dy: torch.Tensor,
                            dS_final: torch.Tensor | None = None, chunk: int = 128
                            ) -> tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_chunk_scan_cuda(x, B, C, dt, loga, chunk)`` given
    ``dy`` (b, H, s, P) (fp32 or bf16) and ``dS_final`` (b, H, P, N) or None
    (zero).  Returns (dx in x's dtype and layout, dB and dC in B's dtype and
    shape -- summed over the heads where B/C are (b, s, N) --, ddt and dloga
    fp32 in dt's and loga's layouts).  Raises where the kernel was not built
    for the inputs: chunk > 128, P > 64, N > 64."""
    global bwd_launches
    chunk = check_shapes(x, B, C, dt, loga, chunk)
    b, H, s, P = x.shape
    N = B.shape[-1]
    tensors = (x, B, C, dt, loga, dy) + (() if dS_final is None else (dS_final,))
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError(f"ssd_chunk_scan_bwd_cuda needs CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype \
            or dy.dtype not in DTYPE_CODES:
        raise TypeError(f"ssd_chunk_scan_bwd_cuda takes x/B/C float32 or bfloat16 of one type "
                        f"and dy float32/bfloat16, got {x.dtype}, {B.dtype}, {C.dtype}, {dy.dtype}")
    if dt.dtype != torch.float32 or loga.dtype != torch.float32:
        raise TypeError(f"dt and loga must be float32, got {dt.dtype}, {loga.dtype}")
    if dy.shape != x.shape or (dS_final is not None and dS_final.shape != (b, H, P, N)):
        raise ValueError(f"dy {tuple(dy.shape)} / dS_final "
                         f"{None if dS_final is None else tuple(dS_final.shape)} do not match "
                         f"x {tuple(x.shape)}, N {N}")
    if chunk > MAX_CHUNK or P > MAX_P or N > MAX_N:
        raise ValueError(f"chunk {chunk}, P {P}, N {N}: the kernel takes chunk <= {MAX_CHUNK}, "
                         f"P <= {MAX_P}, N <= {MAX_N}")
    x, B, C, dy = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, B, C, dy))
    ds_final = None if dS_final is None else dS_final.float().contiguous()
    plan = ssd_bwd_plan(x, B, C, dy, chunk)
    dev = x.device
    dx = _output(x, x.dtype)
    ddt, dloga = _output(dt, torch.float32), _output(loga, torch.float32)
    dB, dC = torch.empty_like(B, memory_format=torch.contiguous_format), \
        torch.empty_like(C, memory_format=torch.contiguous_format)
    n_chunks = s // chunk
    # each chunk's S_in and outgoing dS: [p][n] on the tensor cores, dS [n][p]
    # on the CUDA cores; the chunks' decays on the tensor cores only
    s_in, ds_out = (torch.empty((b, H, n_chunks, P * N), dtype=torch.float32, device=dev)
                    for _ in range(2))
    decay = (torch.empty((b, H, n_chunks), dtype=torch.float32, device=dev)
             if plan.route == "tensor_cores" else None)
    part_b, part_c = (torch.empty((b, plan.groups, s, N), dtype=torch.float32, device=dev)
                      for _ in range(2))
    B4, C4, dB4, dC4 = (_per_head(t, H) for t in (B, C, dB, dC))
    strides = (ctypes.c_longlong * 33)(
        *(st for t in (x, B4, C4, dt, loga, dy, dx, ddt, dloga, dB4, dC4) for st in t.stride()[:3])
    )
    with torch.cuda.device(dev):
        err = _bwd_fn()(
            x.data_ptr(), B.data_ptr(), C.data_ptr(), dt.data_ptr(), loga.data_ptr(),
            dy.data_ptr(), None if ds_final is None else ds_final.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dloga.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            s_in.data_ptr(), ds_out.data_ptr(), None if decay is None else decay.data_ptr(),
            part_b.data_ptr(), part_c.data_ptr(),
            DTYPE_CODES[x.dtype], DTYPE_CODES[dy.dtype], b, H, s, P, N, chunk, strides,
            plan.as_array(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"SSD chunk-scan backward ({plan.route}) launch failed (cudaError "
                           f"{err}) for x {tuple(x.shape)} {x.dtype}, B {tuple(B.shape)}, dy {dy.dtype}, "
                           f"chunk {chunk}, plan {plan}")
    bwd_launches += 1
    return dx, dB, dC, ddt, dloga
