"""Readings that set a training cell's correctness limits, on the card at the
cell's own size (no measured window: the check compares the first steps).

    python3 gpubench/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out <file.jsonl>]

For each of ``--seeds``: the program's checked steps against the reference's
(``check.numbers``), the lower readings.  For each of ``--control-seeds``: the
reference in fp8 put in the program's place (the control), and each planted
fault of ``reference.train.FAULTS``, against the clean reference; a state
left unchanged reads 1 on ``change_gap`` and needs no run.
One JSON line a reading on standard output (and in ``--out``)."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path.cwd()
sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from gpubench import check, spec, train_cell
    from gpubench.reference import train as ref_train

    cell = spec.load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    from repro_torch.kernels import _build

    _build.build_all()
    out = open(args.out, "a") if args.out else None

    def emit(record: dict) -> None:
        line = json.dumps({"workload": cell.name, **record})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        prog = train_cell.Program(cell, seed, device)
        first = prog.first_steps(cell.traffic["checked_steps"])
        peak = torch.cuda.max_memory_allocated() / 1e9
        prog.close()
        del prog
        train_cell.free(device)
        ref = train_cell.reference_steps(cell, seed, device)
        nums, about = check.compare(first, ref)
        emit({"kind": "program", "seed": seed, **nums, **about, "peak_gb": peak,
              "losses": first["losses"], "ref_losses": ref["losses"],
              "seconds": time.perf_counter() - t0})
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        clean = train_cell.reference_steps(cell, seed, device)
        t0 = time.perf_counter()
        fp8 = train_cell.reference_steps(cell, seed, device, "fp8")
        nums, about = check.compare(fp8, clean)
        emit({"kind": "control_fp8", "seed": seed, **nums, **about,
              "losses": fp8["losses"], "ref_losses": clean["losses"],
              "seconds": time.perf_counter() - t0})
        for fault in [f for f in ref_train.FAULTS if f]:
            broken = train_cell.reference_steps(cell, seed, device, "fp32", fault)
            nums, about = check.compare(broken, clean)
            emit({"kind": f"fault_{fault}", "seed": seed, **nums, **about,
                  "losses": broken["losses"]})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
