"""Wrappers of the CUDA RMSNorm kernels (``csrc/rmsnorm.cu``): the forward
and the backward.

Counterpart of the reference's Pallas ``kernels/rmsnorm.py``.  ``rmsnorm_plan``
chooses the route from what it can see of the tensors: ``"registers"`` (one
warp per row, the row held in registers) for at least ``N_SM`` bf16 rows with
an fp32 scale, 16-byte-aligned addresses and a width that a built vector count
covers, ``"block"`` (one block per row) for everything else, decode's few rows
included (a warp each would leave most of the card idle).  The wrapper checks
what the kernels take, allocates the output, launches on PyTorch's current
stream and raises if the launch was refused.  It does not synchronise.
``launches`` counts kernel launches (and nothing else), so a run can show that
it went through the kernel.

The backward (``rmsnorm_bwd_cuda``, dx and an fp32 dscale) takes its route by
the forward's rule, so each row's statistics are summed in the forward's
order.  ``rmsnorm_bwd_plan`` also fixes the grid that walks the rows (on the
register route one block an SM of up to ``bwd_max_warps(vpl)`` warps, each
warp walking rows with the next two in flight), where the threads keep their
columns' dscale partials (registers, or shared memory past
``REGISTER_PARTIALS_VPL`` vectors a lane), and the (blocks, d) workspace of
per-block partial rows that a second kernel sums in a fixed order.
``bwd_launches`` counts its calls (two kernels each).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("block", "registers")   # index = the route's code in the C interface
# 16-byte vectors per lane that the register route is built for: the widths of
# the repo's configs in bf16 (384 -> 2, 1024 -> 4, 2304 -> 9, 2560 -> 10,
# 3072 -> 12, 4096 -> 16, 6144 -> 24).  A row takes the smallest that covers it.
VECTORS_PER_LANE = (2, 4, 9, 10, 12, 16, 24)
N_SM = 132   # streaming multiprocessors of an H100 SXM
MAX_THREADS = 512           # the block route's largest block
SMEM_LIMIT = 232448         # shared memory a block may opt into on an H100
# The backward (csrc/rmsnorm.cu checks each rule on the plan it is given).
BWD_RING = 2                # ring slots of a thread: rows in flight beyond the one worked on
BWD_SMEM = SMEM_LIMIT - 1024   # dynamic shared memory a block may take
REGISTER_PARTIALS_VPL = 12  # register route: the widest row whose partials stay in registers
MAX_BWD_WARPS = 8
# Block route: blocks that walk the rows, at most, and the units (16-byte
# vectors, or elements of an unaligned row) a thread parks, as built.
BWD_BLOCKS = 2 * N_SM
BWD_UNITS = {True: (1, 2, 4), False: (1, 2, 4, 8, 16)}   # by 16-byte vector loads
MAX_BWD_WIDTH = 8192        # 4 fp32 vectors or 16 elements a thread at 512 threads

launches = 0
bwd_launches = 0


@dataclasses.dataclass(frozen=True)
class RMSNormPlan:
    route: str
    vectors_per_lane: int = 0   # 16-byte vectors per lane on the register route


def rmsnorm_plan(x: torch.Tensor, scale: torch.Tensor, out: torch.Tensor) -> RMSNormPlan:
    """The launch of ``rmsnorm_fwd`` for these tensors (x and out contiguous,
    rows of ``d = x.shape[-1]``).  Pure: reads dtypes, shapes and addresses."""
    d = x.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, out)) and d % 8 == 0
    many_rows = x.numel() // d >= N_SM
    if (x.dtype == torch.bfloat16 and scale.dtype == torch.float32 and aligned and many_rows
            and d <= 256 * VECTORS_PER_LANE[-1]):
        return RMSNormPlan("registers", next(v for v in VECTORS_PER_LANE if 256 * v >= d))
    return RMSNormPlan("block")


@dataclasses.dataclass(frozen=True)
class RMSNormBwdPlan:
    route: str
    vectors_per_lane: int   # on the register route, as the forward's (0 on "block")
    blocks: int             # blocks walking the rows; rows of the dscale workspace
    threads: int            # a block: 32 x its warps on "registers", the forward's on "block"
    units: int              # block route: units a thread parks (0 on "registers")
    vector_loads: bool      # 16-byte pieces through the cp.async ring (else elements)
    partials: str           # where a thread's dscale partials live: "registers" or "shared"
    smem_bytes: int         # dynamic shared memory of the row kernel

    def rows_of(self, block: int, rows: int) -> list[int]:
        """The rows block ``block`` walks, as the kernel does: on the register
        route warp w takes ``warps * block + w``, then every ``warps *
        blocks``-th row; on the block route every ``blocks``-th from ``block``."""
        if self.route == "block":
            return list(range(block, rows, self.blocks))
        warps = self.threads // 32
        return sorted(r for w in range(warps) for r in range(warps * block + w, rows, warps * self.blocks))

    def workspace_shape(self, d: int) -> tuple[int, int]:
        """The fp32 partial rows the wrapper allocates: one a block."""
        return (self.blocks, d)


def bwd_warp_smem(vpl: int) -> int:
    """Shared memory of a register-route warp: its ring (x's and dy's pieces
    of a row a slot, 512 bytes a vector) and, past REGISTER_PARTIALS_VPL, its
    partials."""
    return (2 * BWD_RING * vpl + (2 * vpl if vpl > REGISTER_PARTIALS_VPL else 0)) * 512


def bwd_max_warps(vpl: int) -> int:
    """Warps a register-route block walks rows with, at most: as many as shared
    memory holds, up to MAX_BWD_WARPS (one block an SM)."""
    return min(MAX_BWD_WARPS, BWD_SMEM // bwd_warp_smem(vpl))


def rmsnorm_bwd_plan(x: torch.Tensor, scale: torch.Tensor, dx: torch.Tensor) -> RMSNormBwdPlan:
    """The launch of ``rmsnorm_bwd`` (x, dy and dx contiguous, dy 16-byte
    aligned: the wrapper copies one that is not).  The route, the vector count
    and the block route's threads are the forward's for x (``rmsnorm_plan``
    with dx in the place of out), so that r is summed in the forward's order."""
    d = x.shape[-1]
    rows = x.numel() // d
    fwd = rmsnorm_plan(x, scale, dx)
    if fwd.route == "registers":
        vpl = fwd.vectors_per_lane
        warps = min(bwd_max_warps(vpl), -(-rows // N_SM))
        partials = "shared" if vpl > REGISTER_PARTIALS_VPL else "registers"
        return RMSNormBwdPlan("registers", vpl, min(N_SM, -(-rows // warps)), 32 * warps, 0, True,
                              partials, warps * bwd_warp_smem(vpl))
    vec = 16 // x.element_size()
    aligned = d % vec == 0 and all(t.data_ptr() % 16 == 0 for t in (x, dx))
    n_units = -(-d // (vec if aligned else 1))   # a thread per unit, in whole warps
    threads = min(MAX_THREADS, -(-n_units // 32) * 32)
    units = next(u for u in BWD_UNITS[aligned] if u * threads >= n_units)
    return RMSNormBwdPlan("block", 0, min(rows, BWD_BLOCKS), threads, units, aligned, "registers",
                          2 * BWD_RING * units * threads * 16 if aligned else 0)


@functools.cache
def _fn():
    fn = _build.load("rmsnorm").rmsnorm_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, scale, out
        ctypes.c_int, ctypes.c_int,                           # dtype codes
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float,      # rows, d, eps
        ctypes.c_int, ctypes.c_int,                           # route, vectors per lane
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
    plan = rmsnorm_plan(x, scale, out)
    with torch.cuda.device(x.device):   # a launch goes to the current device
        err = _fn()(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype],
            x.numel() // d, d, float(eps), ROUTES.index(plan.route), plan.vectors_per_lane,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel ({plan.route}) launch failed (cudaError {err}) for "
                           f"x {tuple(x.shape)} {x.dtype}")
    launches += 1
    return out


@functools.cache
def _bwd_fn():
    fn = _build.load("rmsnorm").rmsnorm_bwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # x, scale, dy, dx
        ctypes.c_void_p, ctypes.c_void_p,                                      # dscale, partials
        ctypes.c_int, ctypes.c_int,                                            # dtype codes
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float,                       # rows, d, eps
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,                # route, vpl, blocks, threads
        ctypes.c_int, ctypes.c_int,                                            # units, smem bytes
        ctypes.c_void_p,                                                       # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm_bwd_cuda(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``rmsnorm_cuda(x, scale, eps)`` given ``dy``: (dx in
    x's dtype, dscale (d,) fp32).  dy takes x's shape and dtype."""
    global bwd_launches
    if not (x.is_cuda and scale.device == x.device and dy.device == x.device):
        raise ValueError(f"rmsnorm_bwd_cuda needs CUDA tensors on one device, got {x.device}, "
                         f"{scale.device}, {dy.device}")
    if x.dtype not in DTYPE_CODES or scale.dtype not in DTYPE_CODES or dy.dtype != x.dtype:
        raise TypeError(f"rmsnorm_bwd_cuda takes float32/bfloat16 x and dy of one type, got "
                        f"x {x.dtype}, dy {dy.dtype}, scale {scale.dtype}")
    if x.dim() < 1 or scale.shape != (x.shape[-1],) or dy.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)}, scale {tuple(scale.shape)}, dy {tuple(dy.shape)} "
                         "do not match")
    d = x.shape[-1]
    if x.numel() == 0 or d > MAX_BWD_WIDTH:
        raise ValueError(f"rmsnorm_bwd_cuda takes 1 .. {MAX_BWD_WIDTH} columns and some rows, "
                         f"got x {tuple(x.shape)}")
    x = x.contiguous()
    scale = scale.contiguous()
    dy = dy.contiguous()
    if dy.data_ptr() % 16:   # a copy is aligned: the route then follows x alone
        dy = dy.clone()
    dx = torch.empty_like(x)
    plan = rmsnorm_bwd_plan(x, scale, dx)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    partials = torch.empty(plan.workspace_shape(d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _bwd_fn()(
            x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
            partials.data_ptr(), DTYPE_CODES[x.dtype], DTYPE_CODES[scale.dtype],
            x.numel() // d, d, float(eps), ROUTES.index(plan.route), plan.vectors_per_lane,
            plan.blocks, plan.threads, plan.units, plan.smem_bytes,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rmsnorm backward ({plan.route}) launch failed (cudaError {err}) for "
                           f"x {tuple(x.shape)} {x.dtype}")
    bwd_launches += 1
    return dx, dscale
