"""Fault tolerance end to end, at both layers the paper cares about:

* training layer -- a node failure mid-run (an injected exception) triggers
  checkpoint-restart; the run resumes from its last checkpoint and finishes;
* scheduling layer -- Appendix B's backup-node proposal: the FailureManager
  reserves per-minipod backups, promotes one on failure (spread unchanged),
  and falls back to local/cross-pod repair when backups run out; then a fresh
  placement that avoids every failed node.

Run::

    PYTHONPATH=src python -m repro_torch.examples.elastic_failover [--device cpu]
"""

import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.core import (
    Cluster,
    FailureManager,
    FallbackChain,
    JobSpec,
    ModelSpec,
    ScheduleRequest,
    build_comm_matrix,
    max_spreads,
)
from repro_torch.data import SyntheticDataset
from repro_torch.models import ModelOptions, build_model
from repro_torch.optim import AdamWConfig
from repro_torch.train import FaultInjector, Trainer, TrainerConfig


def training_layer(device: str | None = None) -> dict:
    print("=== training layer: crash at step 30, auto-restart ===")
    cfg = get_config("granite-8b").reduced()
    model = build_model(cfg, ModelOptions(param_dtype="float32", compute_dtype="float32",
                                          remat=False), device=device or "cuda")
    ds = SyntheticDataset(cfg.vocab, seq_len=48, global_batch=4)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(
            model, ds, AdamWConfig(lr=2e-3), ckpt_dir=d,
            cfg=TrainerConfig(total_steps=60, ckpt_every=20, log_every=15),
            fault_injector=FaultInjector([30]),
            on_step=lambda h: print(f"  step {h['step']} loss {h['loss']:.3f}", flush=True),
        )
        tr.run()
        restarts = [h for h in tr.history if h.get("event") == "restart"]
        print(f"restarts: {len(restarts)} ({restarts[0]['error']})")
        latest = tr.ckpt.latest_step()
        print(f"finished at checkpoint step {latest}")
        assert latest == 60 and len(restarts) == 1
    return {"restarts": [r["error"] for r in restarts], "latest_step": latest,
            "losses": tr.losses()}


def scheduling_layer() -> dict:
    print("\n=== scheduling layer: backup-node promotion (Appendix B) ===")
    cluster = Cluster.uniform(4, 20)
    model = ModelSpec(name="7b", hidden=4096, layers=32, vocab=50304,
                      seq_len=2048, global_batch=512, d_ff=16384)
    comm = build_comm_matrix(JobSpec(n_gpus=32 * 8, tp=4, pp=4, model=model))
    # MILP first; degrade to topo-aware if it cannot produce a placement.
    scheduler = FallbackChain("mip", "topo-aware")
    res = scheduler.schedule(ScheduleRequest(comm=comm, cluster=cluster, alpha=0.3))
    cluster.allocate(res.placement.node_ids())
    print(f"placed 32 nodes via {res.method}, spreads={max_spreads(res.placement)}")

    fm = FailureManager(res.placement, cluster, backup_frac=0.1)
    print(f"backups reserved: {fm.backup_count()}")
    pods_with_backup = {p for p, b in fm.backups.items() if b}
    victims = [n for n in res.placement.node_ids()
               if cluster.nodes[n].minipod in pods_with_backup][:3]
    events = []
    for v in victims:
        ev = fm.on_failure(v)
        print(f"  node {v} failed -> {ev.replacement} via {ev.kind}; "
              f"spreads now ({ev.dp_spread_after}, {ev.pp_spread_after})")
        events.append({"failed": v, "replacement": ev.replacement, "kind": ev.kind,
                       "dp_spread_after": ev.dp_spread_after,
                       "pp_spread_after": ev.pp_spread_after})
    assert all(e.kind in ("backup", "local", "cross-pod") for e in fm.events)
    print("repair events:", [e.kind for e in fm.events])

    # Constrained re-placement: plan a fresh placement that avoids every node
    # that has ever failed, falling back to topo-aware if the constrained MILP
    # is infeasible.
    cluster.release(res.placement.node_ids())
    failed = frozenset(victims)
    re_res = scheduler.schedule(ScheduleRequest(
        comm=comm, cluster=cluster, alpha=0.3, excluded_nodes=failed,
    ))
    assert not (set(re_res.placement.node_ids()) & failed)
    print(f"re-placed around {len(failed)} failed nodes via {re_res.method}, "
          f"spreads={max_spreads(re_res.placement)}")
    return {"method": res.method, "spreads": max_spreads(res.placement),
            "backups": fm.backup_count(), "events": events,
            "replaced_method": re_res.method, "replaced_spreads": max_spreads(re_res.placement),
            "replaced_nodes": sorted(re_res.placement.node_ids())}


def main(device: str | None = None) -> dict:
    out = {"training": training_layer(device), "scheduling": scheduling_layer()}
    print("\nOK")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
