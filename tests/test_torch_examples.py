"""The port's four examples (``repro_torch.examples``) run on the CPU, print
``OK``, and their scheduling output equals what the reference's scheduling
calls (``repro.core``, ``repro.serve.place_replicas``) give on the same
inputs.  The reference's scripts themselves are not run here:
``examples/schedule_and_launch.py`` sets ``XLA_FLAGS`` before it imports jax."""

import numpy as np
import pytest

import repro.core as R
from repro.configs import get_config as ref_config
from repro.serve import ReplicaSpec as RefReplicaSpec
from repro.serve import place_replicas as ref_place_replicas
from repro.serve.placement import serving_model_spec as ref_serving_spec
from repro_torch.examples import elastic_failover, quickstart, schedule_and_launch, serve


def test_quickstart(capsys):
    out = quickstart.main(device="cpu")
    printed = capsys.readouterr().out
    assert printed.rstrip().endswith("OK")
    assert out["losses"][-1] < out["losses"][0] and len(out["losses"]) == 10
    assert out["checkpoints"] == [100, 150, 200]    # keep_last 3 of every 50 steps


def test_serve(capsys):
    out = serve.main(device="cpu")
    printed = capsys.readouterr().out
    assert printed.rstrip().endswith("OK")
    cluster = R.Cluster.uniform(4, 4)
    cfg = ref_config("glm4-9b").reduced()
    want = ref_place_replicas(cluster, 2, RefReplicaSpec(model=ref_serving_spec(cfg), tp=8,
                                                         pp=2, n_gpus=16),
                              scheduler="mip,topo-aware")
    assert out["replicas"] == [{"replica_id": p.replica_id, "node_ids": list(p.node_ids),
                                "method": p.method, "pp_spread": p.result.pp_spread}
                               for p in want.placements]
    for p in want.placements:
        assert (f"replica {p.replica_id}: nodes {p.node_ids} via {p.method} "
                f"(pp_spread={p.result.pp_spread})") in printed
    assert out["completed"] == 16


def reference_schedule():
    """The reference example's steps 1-5 through ``repro.core``: (comm,
    affinity, mip result, packing result, permutation)."""
    cluster = R.Cluster.uniform(4, 2)
    arch = ref_config("minicpm-2b")
    mspec = R.ModelSpec(name=arch.name, hidden=arch.d_model, layers=arch.n_layers,
                        vocab=arch.vocab, seq_len=64, global_batch=16, d_ff=arch.d_ff)
    job = R.JobSpec(n_gpus=64, tp=4, pp=2, model=mspec)
    comm = R.build_comm_matrix(job)
    affinity = R.CharacterizationDB().affinity_for(comm)
    alpha, beta, unit = affinity
    request = R.ScheduleRequest(comm=comm, cluster=cluster, alpha=alpha, beta=beta, unit=unit)
    res = R.get_scheduler("mip").schedule(request)
    base = R.get_scheduler("gpu-packing").schedule(request)
    return comm, affinity, res, base, R.device_permutation(res.placement, job.tp)


def minipod_spread(grid: np.ndarray, axis: int, devices_per_pod: int = 16) -> int:
    """The reference's ``mesh_group_spread`` on a device grid: the most
    minipods any group along ``axis`` touches."""
    pods = np.moveaxis(grid // devices_per_pod, axis, 0).reshape(grid.shape[axis], -1)
    return max(len(set(pods[:, c])) for c in range(pods.shape[1]))


def test_schedule_and_launch(capsys):
    out = schedule_and_launch.main(device="cpu")
    printed = capsys.readouterr().out
    assert printed.rstrip().endswith("OK: scheduled, placed, and trained on the Arnold-aligned mesh")
    comm, affinity, res, base, perm = reference_schedule()
    assert out["comm_shape"] == comm.shape and out["affinity"] == affinity
    assert out["mip"] == {"method": res.method, "spreads": (res.dp_spread, res.pp_spread)}
    assert out["packing"] == {"method": base.method, "spreads": (base.dp_spread, base.pp_spread)}
    arnold, naive = np.asarray(perm).reshape(8, 8), np.arange(64).reshape(8, 8)
    assert out["grid_spreads"] == {
        name: {"model": minipod_spread(g, 1), "data": minipod_spread(g, 0)}
        for name, g in (("arnold", arnold), ("naive", naive))}
    assert out["mesh_gpus"] == list(perm[:4])   # the 4 gloo ranks drive Arnold's first GPUs
    assert f"Arnold spreads (dp, pp): ({res.dp_spread}, {res.pp_spread}) [{res.method}," in printed
    assert f"packing spreads (dp, pp): ({base.dp_spread}, {base.pp_spread})" in printed
    assert len(out["losses"]) == schedule_and_launch.STEPS and np.isfinite(out["losses"]).all()


def reference_failover() -> dict:
    """The reference example's scheduling layer through ``repro.core``."""
    cluster = R.Cluster.uniform(4, 20)
    model = R.ModelSpec(name="7b", hidden=4096, layers=32, vocab=50304, seq_len=2048,
                        global_batch=512, d_ff=16384)
    comm = R.build_comm_matrix(R.JobSpec(n_gpus=32 * 8, tp=4, pp=4, model=model))
    scheduler = R.FallbackChain("mip", "topo-aware")
    res = scheduler.schedule(R.ScheduleRequest(comm=comm, cluster=cluster, alpha=0.3))
    cluster.allocate(res.placement.node_ids())
    fm = R.FailureManager(res.placement, cluster, backup_frac=0.1)
    backups = fm.backup_count()
    pods = {p for p, b in fm.backups.items() if b}
    victims = [n for n in res.placement.node_ids() if cluster.nodes[n].minipod in pods][:3]
    events = []
    for v in victims:
        ev = fm.on_failure(v)
        events.append({"failed": v, "replacement": ev.replacement, "kind": ev.kind,
                       "dp_spread_after": ev.dp_spread_after, "pp_spread_after": ev.pp_spread_after})
    cluster.release(res.placement.node_ids())
    re_res = scheduler.schedule(R.ScheduleRequest(comm=comm, cluster=cluster, alpha=0.3,
                                                  excluded_nodes=frozenset(victims)))
    return {"method": res.method, "spreads": R.max_spreads(res.placement), "backups": backups,
            "events": events, "replaced_method": re_res.method,
            "replaced_spreads": R.max_spreads(re_res.placement),
            "replaced_nodes": sorted(re_res.placement.node_ids())}


def test_elastic_failover(capsys):
    out = elastic_failover.main(device="cpu")
    printed = capsys.readouterr().out
    assert printed.rstrip().endswith("OK")
    assert out["training"]["latest_step"] == 60
    assert out["training"]["restarts"] == ["injected node failure at step 30"]
    want = reference_failover()
    assert out["scheduling"] == want
    for ev in want["events"]:
        assert (f"node {ev['failed']} failed -> {ev['replacement']} via {ev['kind']}; "
                f"spreads now ({ev['dp_spread_after']}, {ev['pp_spread_after']})") in printed


@pytest.mark.parametrize("module", [elastic_failover, quickstart, schedule_and_launch, serve],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_the_card_is_the_default(module, monkeypatch):
    """Without ``device`` an example runs on the card; where there is none it
    raises before it trains or serves anything on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda|CUDA"):
        module.main()
