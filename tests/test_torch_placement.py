"""The port's workload model, spread metric, rank order, affinity DB and
serving-replica placement against the reference's, on the same inputs.
Every comparison is exact (``==`` / ``np.array_equal``)."""

import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.serve as RS
import repro.topo as RT
import repro_torch.core as P
import repro_torch.serve as PS
import repro_torch.topo as PT
from repro.configs import get_config as ref_config
from repro.serve.placement import serving_model_spec as ref_serving_spec
from repro_torch.configs import get_config as port_config
from repro_torch.serve.placement import serving_model_spec as port_serving_spec

PKGS = (R, P)

# the ModelSpecs of the reference's own tests: its conftest's 7B, the
# rank-order/mesh model, the MoE and dense specs of its comm-matrix tests
MODEL_SPECS = {
    "gpt-7b": dict(name="gpt-7b", hidden=4096, layers=32, vocab=50304, seq_len=2048,
                   global_batch=1024, micro_batch=1, d_ff=16384),
    "m": dict(name="m", hidden=1024, layers=8, vocab=5000, seq_len=128, global_batch=64,
              d_ff=4096),
    "moe": dict(name="moe", hidden=4096, layers=24, vocab=50304, seq_len=2048,
                global_batch=512, micro_batch=1, n_experts=16, top_k=4, d_expert=8192),
    "d": dict(name="d", hidden=4096, layers=24, vocab=50304, seq_len=2048, global_batch=512,
              d_ff=16384),
    "no-dff": dict(name="no-dff", hidden=2048, layers=12, vocab=32000, seq_len=1024,
                   global_batch=256, micro_batch=2, bytes_per_element=1),
}
JOBS = [(8, 8, 1), (64, 8, 2), (96, 4, 2), (128, 4, 2), (256, 2, 4), (512, 8, 8), (1024, 1, 8),
        (4096, 8, 8), (9600, 8, 8)]
ARCHS = ["glm4-9b", "minicpm-2b", "qwen3-moe-235b-a22b"]


def assert_same_comm(ref, port):
    for f in ("n_rows", "n_cols", "v_w", "v_d", "v_p", "v_e"):
        assert getattr(port, f) == getattr(ref, f), f
    assert (port.shape, port.n_cells) == (ref.shape, ref.n_cells)
    assert np.array_equal(port.cell_ids(), ref.cell_ids())
    assert port.ratios() == ref.ratios()
    job_r, job_p = ref.job, port.job
    assert (job_p.dp, job_p.n_nodes, job_p.n_microbatches, job_p.gpu_type) == \
        (job_r.dp, job_r.n_nodes, job_r.n_microbatches, job_r.gpu_type)


def comm_pair(model_kw, n_gpus, tp, pp):
    out = []
    for pkg in PKGS:
        job = pkg.JobSpec(n_gpus=n_gpus, tp=tp, pp=pp, model=pkg.ModelSpec(**model_kw))
        vols = (pkg.dp_volume_bytes(job), pkg.pp_volume_bytes(job), pkg.ep_volume_bytes(job))
        out.append((pkg.build_comm_matrix(job), vols))
    return out


class TestCommMatrix:
    @pytest.mark.parametrize("job", JOBS, ids=lambda j: "x".join(map(str, j)))
    @pytest.mark.parametrize("model", sorted(MODEL_SPECS))
    def test_same_matrix_and_volumes(self, model, job):
        try:
            (ref, ref_vols), (port, port_vols) = comm_pair(MODEL_SPECS[model], *job)
        except ValueError as exc:            # both refuse the same shapes
            with pytest.raises(ValueError, match=str(exc)):
                P.build_comm_matrix(P.JobSpec(*job, model=P.ModelSpec(**MODEL_SPECS[model])))
            return
        assert port_vols == ref_vols
        assert_same_comm(ref, port)

    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("job", [(16, 8, 2), (64, 8, 1), (128, 4, 4), (512, 8, 8)],
                             ids=lambda j: "x".join(map(str, j)))
    def test_port_configs_through_serving_model_spec(self, arch, job):
        ref_spec = ref_serving_spec(ref_config(arch), batch=16, seq_len=2048)
        port_spec = port_serving_spec(port_config(arch), batch=16, seq_len=2048)
        assert dataclasses.asdict(port_spec) == dataclasses.asdict(ref_spec)
        assert port_spec.is_moe == ref_spec.is_moe == (arch == "qwen3-moe-235b-a22b")
        (ref, ref_vols), (port, port_vols) = comm_pair(dataclasses.asdict(ref_spec), *job)
        assert port_vols == ref_vols
        if port_spec.is_moe:
            assert port.v_e > 0
        assert_same_comm(ref, port)

    @pytest.mark.parametrize("job", [(12, 4, 1), (64, 8, 3), (64, 16, 1), (32, 4, 8)])
    def test_same_refusals(self, job):
        msgs = []
        for pkg in PKGS:
            with pytest.raises(ValueError) as info:
                pkg.build_comm_matrix(pkg.JobSpec(*job, model=pkg.ModelSpec(
                    **MODEL_SPECS["gpt-7b"])))
            msgs.append(str(info.value))
        assert msgs[0] == msgs[1]


def scheduled(pkg, name, spec, n_gpus, tp, pp, frag_seed=None, alpha=0.3, unit="pp"):
    cluster = pkg.Cluster(list(spec)) if len(spec) != 2 else pkg.Cluster.uniform(*spec)
    if frag_seed is not None:
        rng = np.random.default_rng(frag_seed)
        cluster.allocate(rng.choice(cluster.n_nodes, cluster.n_nodes // 3,
                                    replace=False).tolist())
    comm = pkg.build_comm_matrix(pkg.JobSpec(n_gpus=n_gpus, tp=tp, pp=pp,
                                             model=pkg.ModelSpec(**MODEL_SPECS["m"])))
    sched = pkg.HierarchicalScheduler() if name == "hier" else pkg.get_scheduler(name)
    return sched.schedule(pkg.ScheduleRequest(comm=comm, cluster=cluster, alpha=alpha,
                                              unit=unit, seed=5)).placement


PLACEMENTS = [
    ("mip", (4, 4), 64, 4, 2, None), ("random-fit", (6, 8), 256, 8, 4, None),
    ("random-fit", (5, 9), 96, 2, 2, 1), ("best-fit", (7, 5, 9, 3, 6), 160, 8, 4, None),
    ("topo-aware", (7, 5, 9, 3, 6), 128, 4, 4, 2), ("hier", (8, 8), 256, 8, 8, 3),
    ("gpu-packing", (1, 12), 64, 8, 8, None),
]


def placement_pair(case):
    return [scheduled(pkg, *case) for pkg in PKGS]


def fabric_placement_pair(kind, caps, n_gpus, tp, pp, seed):
    out = []
    for pkg, topo in ((R, RT), (P, PT)):
        cluster = pkg.Cluster.from_fabric(topo.comparable_fabric(kind, caps))
        comm = pkg.build_comm_matrix(pkg.JobSpec(n_gpus=n_gpus, tp=tp, pp=pp,
                                                 model=pkg.ModelSpec(**MODEL_SPECS["m"])))
        out.append(pkg.get_scheduler("random-fit").schedule(pkg.ScheduleRequest(
            comm=comm, cluster=cluster, seed=seed)).placement)
    return out


class TestSpreads:
    def assert_same_spreads(self, ref, port):
        from repro.core import spread as rs
        from repro_torch.core import spread as ps

        assert np.array_equal(port.domain_of(), ref.domain_of())
        assert np.array_equal(port.minipod_of(), ref.minipod_of())
        assert port.node_ids() == ref.node_ids()
        assert P.max_spreads(port) == R.max_spreads(ref)
        assert P.max_hop_diameters(port) == R.max_hop_diameters(ref)
        assert ps.mean_spreads(port) == rs.mean_spreads(ref)
        for alpha in (0.0, 0.3, 0.5, 0.7, 1.0):
            assert P.weighted_spread(port, alpha) == R.weighted_spread(ref, alpha)
        assert P.weighted_spread(port, 0.25, 0.75) == R.weighted_spread(ref, 0.25, 0.75)
        with pytest.raises(ValueError, match="alpha"):
            P.weighted_spread(port, 0.5, 0.6)

    @pytest.mark.parametrize("case", PLACEMENTS, ids=lambda c: f"{c[0]}-{c[2]}")
    def test_same_spreads_of_scheduled_placements(self, case):
        self.assert_same_spreads(*placement_pair(case))

    @pytest.mark.parametrize("kind", ["clos", "rail-only", "torus", "dragonfly"])
    def test_same_spreads_on_every_fabric(self, kind):
        for seed in range(3):
            self.assert_same_spreads(*fabric_placement_pair(
                kind, [5, 7, 6, 6, 8, 4, 6, 6], 128, 4, 4, seed))

    def test_group_metrics(self):
        from repro.core import spread as rs
        from repro_torch.core import spread as ps

        rng = np.random.default_rng(0)
        for _ in range(100):
            k = int(rng.integers(1, 6))
            domains = rng.integers(0, k, size=int(rng.integers(1, 9)))
            assert ps.group_spread(domains) == rs.group_spread(domains)
            onehot = np.eye(k, dtype=int)[domains]
            assert ps.distance_onehot(onehot) == rs.distance_onehot(onehot)
        with pytest.raises(ValueError):
            ps.distance_onehot(np.zeros(3))

    def test_same_placement_validation(self):
        msgs = []
        for pkg in PKGS:
            comm = pkg.build_comm_matrix(pkg.JobSpec(n_gpus=32, tp=8, pp=2,
                                                     model=pkg.ModelSpec(**MODEL_SPECS["m"])))
            cluster = pkg.Cluster.uniform(2, 4)
            errs = []
            for a in (np.arange(6).reshape(2, 3), np.array([[0, 1], [1, 2]])):
                with pytest.raises(ValueError) as info:
                    pkg.Placement(comm=comm, assignment=a, cluster=cluster)
                errs.append(str(info.value))
            msgs.append(errs)
        assert msgs[0] == msgs[1]


class TestRankOrder:
    @pytest.mark.parametrize("case", PLACEMENTS, ids=lambda c: f"{c[0]}-{c[2]}")
    def test_same_permutation(self, case):
        from repro.core import rank_assign as rr
        from repro_torch.core import rank_assign as pr

        ref, port = placement_pair(case)
        tp = case[3]
        assert pr.node_rank_order(port) == rr.node_rank_order(ref)
        for gpus in (8, 16):
            want = R.logical_to_physical_gpus(ref, tp, gpus)
            got = P.logical_to_physical_gpus(port, tp, gpus)
            assert np.array_equal(got, want) and got.dtype == want.dtype
            assert P.device_permutation(port, tp, gpus) == R.device_permutation(ref, tp, gpus)
        assert P.device_permutation(port, tp) == R.device_permutation(ref, tp)


class TestAffinity:
    def comms(self, pkg):
        for model in sorted(MODEL_SPECS):
            for n_gpus, tp, pp in JOBS:
                for gpu in ("H800", "L20", "H100"):
                    try:
                        yield pkg.build_comm_matrix(pkg.JobSpec(
                            n_gpus=n_gpus, tp=tp, pp=pp, gpu_type=gpu,
                            model=pkg.ModelSpec(**MODEL_SPECS[model])))
                    except ValueError:
                        continue

    def test_same_affinity_for_every_job(self):
        ref_db, port_db = R.CharacterizationDB(), P.CharacterizationDB()
        assert [dataclasses.asdict(r) for r in port_db.records] == \
            [dataclasses.asdict(r) for r in ref_db.records]
        pairs = list(zip(self.comms(R), self.comms(P)))
        assert len(pairs) > 50
        for ref, port in pairs:
            assert port_db.affinity_for(port) == ref_db.affinity_for(ref)
        for r1, r2 in ((0, 0), (100, 100), (170, 55), (35, 30), (1e4, 1)):
            for gpu in (None, "H800", "L20", "H100"):
                assert dataclasses.asdict(port_db.lookup(r1, r2, gpu)) == \
                    dataclasses.asdict(ref_db.lookup(r1, r2, gpu))

    def test_records_and_save_load_round_trip(self, tmp_path):
        extra = dict(gpu_type="H800", model_name="extra", r1=90.0, r2=40.0, j_dp=0.0,
                     j_pp=0.0, unit="dp")
        dbs = []
        for pkg, name in ((R, "ref.json"), (P, "port.json")):
            db = pkg.CharacterizationDB()
            db.add(pkg.CharRecord(**extra))
            assert db.records[-1].affinity() == (0.5, 0.5)
            db.save(tmp_path / name)
            dbs.append(pkg.CharacterizationDB.load(tmp_path / name))
        assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
        # each package reads the other's file
        cross = P.CharacterizationDB.load(tmp_path / "ref.json")
        assert [dataclasses.asdict(r) for r in cross.records] == \
            [dataclasses.asdict(r) for r in dbs[0].records] == \
            [dataclasses.asdict(r) for r in dbs[1].records]
        for ref, port in zip(self.comms(R), self.comms(P)):
            assert dbs[1].affinity_for(port) == dbs[0].affinity_for(ref)


class _AlwaysInfeasible:
    name = "always-infeasible"

    def __init__(self, pkg):
        self._pkg = pkg

    def schedule(self, request):
        raise self._pkg.Infeasible("synthetic failure")


def replica_spec(pkg, serve_pkg, arch="glm4-9b", tp=8, pp=2, n_gpus=16):
    spec = (ref_serving_spec(ref_config(arch)) if pkg is R
            else port_serving_spec(port_config(arch)))
    return serve_pkg.ReplicaSpec(model=spec, tp=tp, pp=pp, n_gpus=n_gpus)


class TestPlaceReplicas:
    @pytest.mark.parametrize("scheduler", ["mip", "mip,topo-aware", "topo-aware", "best-fit",
                                           "gpu-packing", "random-fit", "hier,mip"])
    @pytest.mark.parametrize("arch,shape", [("glm4-9b", (8, 2, 16)), ("minicpm-2b", (8, 1, 8)),
                                            ("qwen3-moe-235b-a22b", (8, 4, 32))])
    def test_same_replicas(self, scheduler, arch, shape):
        runs = []
        for pkg, serve in ((R, RS), (P, PS)):
            cluster = pkg.Cluster.uniform(4, 6)
            cluster.allocate([1, 7, 8, 20])
            sched = scheduler
            if scheduler.startswith("hier"):   # a fresh cache, not the registry's
                sched = pkg.FallbackChain(pkg.HierarchicalScheduler(), "mip")
            rs = serve.place_replicas(cluster, 3, replica_spec(pkg, serve, arch, *shape),
                                      scheduler=sched, alpha=0.4, seed=2)
            ids = rs.node_ids()
            assert len(ids) == len(set(ids)) == 3 * shape[2] // 8
            assert not cluster.is_free(ids[0])
            runs.append(([(p.replica_id, p.node_ids, p.method, p.result.objective,
                           p.result.dp_spread, p.result.pp_spread,
                           p.result.stats.get("served_by")) for p in rs.placements],
                         sorted(rs.minipods_used()), rs.n_replicas))
            rs.release()
            rs.release()
            assert cluster.n_free == cluster.n_nodes - 4
        assert runs[1] == runs[0]

    def test_fallback_chain(self):
        runs = []
        for pkg, serve in ((R, RS), (P, PS)):
            cluster = pkg.Cluster.uniform(4, 4)
            chain = pkg.FallbackChain(_AlwaysInfeasible(pkg), "topo-aware")
            rs = serve.place_replicas(cluster, 2, replica_spec(pkg, serve), scheduler=chain)
            runs.append([(p.node_ids, p.method, p.result.stats["fallbacks"])
                         for p in rs.placements])
        assert runs[0][0][1] == "topo-aware"
        assert runs[1] == runs[0]

    @pytest.mark.parametrize("n_replicas,scheduler", [(3, "mip,topo-aware"), (5, "mip"),
                                                      (9, "best-fit")])
    def test_same_rollback_on_infeasible(self, n_replicas, scheduler):
        msgs = []
        for pkg, serve in ((R, RS), (P, PS)):
            cluster = pkg.Cluster.uniform(2, 4) if n_replicas != 3 else pkg.Cluster.uniform(2, 2)
            cluster.allocate([0])
            before = cluster.free_mask_view().copy()
            with pytest.raises(pkg.Infeasible) as info:
                serve.place_replicas(cluster, n_replicas, replica_spec(pkg, serve),
                                     scheduler=scheduler)
            assert np.array_equal(cluster.free_mask_view(), before)
            msgs.append(str(info.value))
        assert msgs[1] == msgs[0]

    def test_bad_replica_count(self):
        with pytest.raises(ValueError, match="n_replicas"):
            PS.place_replicas(P.Cluster.uniform(2, 2), 0, replica_spec(P, PS))

    def test_exports(self):
        assert {"ReplicaPlacement", "ReplicaSet", "ReplicaSpec", "place_replicas"} <= \
            set(PS.__all__)
