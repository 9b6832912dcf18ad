"""The benchmark of the PyTorch/CUDA port on NVIDIA H100s.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``gpubench/`` and
the port (``src/repro_torch``).  It runs one cell of ``BENCHMARK.json`` on the
cards of the machine it is started on, by the code that the cell's traffic
mix names (``gpubench/<kind>_cell.py``), and prints, as the last line of its
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``: each number the correctness check compared, with its limit (also
the last lines of standard error).  It exits non-zero and prints no result
where there is no CUDA device, fewer than the cell asks for, or where a
module of JAX or of the JAX package ``repro`` is loaded once the window has
closed.  Caches of compiled kernels stay under the checkout's ``build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """perf_counter's reading at this process's start (from /proc), else now."""
    now = time.perf_counter()
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return now - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


T_START = _process_start()
ROOT = Path.cwd()
sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(ROOT / "src")]
BUILD = ROOT / "build"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(BUILD / sub)
os.environ["USE_FLAX"] = "0"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in (m.split(".")[0] for m in list(sys.modules)) if name in FORBIDDEN})


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi not available ({e})"


def result_line(cell, run, trace: bool, device_info: dict, correct: bool) -> dict:
    from gpubench import check, spec

    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end, run, cell.root)
    out = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        out["device"] = {**device_info, "busy_s": run.trace.busy_s, "window_s": run.trace.window_s}
        out["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
    out["check"] = check.summary(run.nums, cell.limits)
    return out


def main(argv=None, device=None, wrap_step=None, root: Path = ROOT) -> int:
    """``device``, ``wrap_step`` and ``root`` are for the tests, which run a
    cell on the CPU: from the command line the cell runs on CUDA devices
    only, from the working directory's checkout."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from gpubench import check, spec

    cell = spec.load_cell(args.workload, root)
    run_cell = spec.runner(cell)
    chips = cell.workload["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{cell.name} needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        from repro_torch.kernels import _build

        _build.build_all()
        log(f"nvcc build {_build.build_seconds:.3f} s (0 when the libraries were cached)")
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START, wrap_step)
    if device.type == "cuda":
        log(f"card: {power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": run.peak_bytes}
    correct = run.failed == 0 and check.judge(run.nums, cell.limits)
    line = result_line(cell, run, bool(args.trace), info, correct)
    for name in sorted(set(run.nums) - set(cell.limits)):
        print(f"reading {name} {run.nums[name]!r} (not compared in this cell)", file=sys.stderr)
    for text in check.lines(run.nums, cell.limits):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
