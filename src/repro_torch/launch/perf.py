"""Hill-climbing driver, the counterpart of the reference's
``launch/perf.py``: run named experiment variants of one (arch x shape) cell
on the single-pod mesh through the dry run (``launch/dryrun.py``),
re-deriving the roofline per variant, and append hypothesis -> before ->
after records to ``reports/perf_<arch>_<shape>.json``.

Usage:
    python -m repro_torch.launch.perf --arch granite-8b --shape train_4k \
        --variant baseline --variant no_fsdp ...

The variants are the reference's.  Those that set ``attn_impl`` /
``attn_chunk`` (``attn_chunk_*``, ``attn_xla``) are refused by name: the port
leaves those options out, since its flash-attention kernel computes what they
select, and running them as the baseline would record a variant that was
never tried.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.launch.dryrun import LEFT_OUT_OPTIONS, run_cell

#: named experiment variants: (opt_overrides, rule_overrides, microbatches)
VARIANTS: dict[str, dict] = {
    "baseline": {},
    # --- collective-bound candidates -------------------------------------
    "no_fsdp": {"rule_overrides": {"fsdp": ()}},          # replicate weights
    "mb1": {"microbatches": 1},                           # one regather/step
    "mb2": {"microbatches": 2},
    "mb4": {"microbatches": 4},
    # --- memory-bound candidates ------------------------------------------
    "no_remat": {"opt_overrides": {"remat": False}},
    "seq_parallel": {"rule_overrides": {"seq_sp": ("model",)}},
    "remat_save_tp": {"opt_overrides": {"remat_policy": "save_tp_outputs"}},
    "sp_remat_tp": {"rule_overrides": {"seq_sp": ("model",)},
                    "opt_overrides": {"remat_policy": "save_tp_outputs"}},
    "attn_chunk_512": {"opt_overrides": {"attn_impl": "chunked", "attn_chunk": 512}},
    "attn_chunk_2048": {"opt_overrides": {"attn_impl": "chunked", "attn_chunk": 2048}},
    "attn_chunk_4096": {"opt_overrides": {"attn_impl": "chunked", "attn_chunk": 4096}},
    "attn_xla": {"opt_overrides": {"attn_impl": "xla"}},
    # --- compute/efficiency -----------------------------------------------
    "moe_cap_1.0": {"opt_overrides": {"moe_capacity_factor": 1.0}},
    "moe_cap_2.0": {"opt_overrides": {"moe_capacity_factor": 2.0}},
    # combinations get added per-cell during the hillclimb
    "no_fsdp_mb1": {"rule_overrides": {"fsdp": ()}, "microbatches": 1},
    # full ZeRO-3 data parallelism over ALL chips, no tensor parallelism:
    # eliminates the per-layer TP activation all-reduces entirely; weights
    # stream via all-gather instead (16 GB/pass for an 8B model)
    "fsdp_only": {"rule_overrides": {
        "heads": (), "kv_heads": (), "ffn": (), "vocab": (),
        "fsdp": ("data", "model"), "zero": ("data", "model"),
        "batch": ("data", "model")}, "microbatches": 1},
    "fsdp_only_remat_tp": {"opt_overrides": {"remat_policy": "save_tp_outputs"},
                           "rule_overrides": {
        "heads": (), "kv_heads": (), "ffn": (), "vocab": (),
        "fsdp": ("data", "model"), "zero": ("data", "model"),
        "batch": ("data", "model")}, "microbatches": 1},
    "fsdp_only_mb2": {"rule_overrides": {
        "heads": (), "kv_heads": (), "ffn": (), "vocab": (),
        "fsdp": ("data", "model"), "zero": ("data", "model"),
        "batch": ("data", "model")}, "microbatches": 2},
    "mb1_seqpar": {"microbatches": 1, "rule_overrides": {"seq_sp": ("model",)}},
}

#: variants the port refuses, with the reason
REFUSED: dict[str, str] = {
    name: (f"variant {name!r} sets {sorted(set(kw['opt_overrides']) & set(LEFT_OUT_OPTIONS))}, "
           "options the port leaves out: its flash-attention kernel computes what attn_impl "
           "and attn_chunk select")
    for name, kw in VARIANTS.items()
    if set(kw.get("opt_overrides", {})) & set(LEFT_OUT_OPTIONS)
}


def run_variant(arch: str, shape: str, name: str) -> dict:
    """The dry-run record of one variant (single-pod mesh, analysis at the
    true microbatch count); a refused variant raises ValueError."""
    if name in REFUSED:
        raise ValueError(REFUSED[name])
    rec = run_cell(arch, shape, multi_pod=False, with_analysis=True,
                   analysis_true_microbatches=True, **VARIANTS[name])
    rec["variant"] = name
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", action="append", default=None,
                    choices=sorted(VARIANTS), dest="variants")
    ap.add_argument("--out", default="reports")
    args = ap.parse_args(argv)

    variants = args.variants or ["baseline"]
    refused = [name for name in variants if name in REFUSED]
    if refused:
        ap.error("; ".join(REFUSED[name] for name in refused))
    out = pathlib.Path(args.out) / f"perf_{args.arch}_{args.shape}.json"
    records = []
    if out.exists():
        records = json.loads(out.read_text())
    done = {r["variant"] for r in records}

    for name in variants:
        if name in done:
            print(f"{name}: cached")
            continue
        try:
            rec = run_variant(args.arch, args.shape, name)
        except Exception as e:  # noqa: BLE001
            rec = {"variant": name, "status": f"FAILED: {e}"}
            print(f"{name}: FAILED {e}")
        records.append(rec)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(records, indent=1))
    # summary table
    print(f"\n{'variant':18s} {'dominant':10s} {'compute_s':>10s} {'memory_s':>10s} "
          f"{'coll_s':>10s} {'bound_s':>10s} {'peakGiB':>8s}")
    for r in records:
        if r.get("status") != "ok" or "roofline" not in r:
            continue
        rl = r["roofline"]
        bound = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        peak = (r["memory"]["peak_bytes_per_device"] or 0) / 2**30
        print(f"{r['variant']:18s} {rl['dominant']:10s} {rl['compute_s']:10.3e} "
              f"{rl['memory_s']:10.3e} {rl['collective_s']:10.3e} "
              f"{bound:10.3e} {peak:8.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
