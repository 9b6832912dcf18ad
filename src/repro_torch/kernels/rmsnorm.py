"""Wrapper of the CUDA RMSNorm kernels (``csrc/rmsnorm.cu``).

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

launches = 0


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
