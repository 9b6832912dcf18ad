"""The port's trace simulator against the reference's: the same seeded
traces replayed through ``repro.core.TraceSimulator`` and
``repro_torch.core.TraceSimulator`` -- vectorized and legacy, with and
without an LPJ, reservations, JCT backfill (oracle and fitted GBM),
failure re-plans and preemptable squatters -- give equal ``SimResult``s,
field by field and bit for bit.  Also ``poisson_trace``,
``throughput_of_placement``, ``bench_sim``'s parity trace and its month
(100 000 jobs on 9984 nodes) on both packages, with the month's digest
held equal to the constant ``chip_smoke.py`` pins."""

import dataclasses
import importlib.util
import json
import math
from pathlib import Path

import pytest

import repro.core as R
import repro.topo as RT
import repro_torch.core as P
import repro_torch.topo as PT

ROOT = Path(__file__).resolve().parents[1]
PKGS = (R, P)


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = chip_smoke()


def model7b(pkg):
    return pkg.ModelSpec(**CS.PLACE_MODEL7B)


def comm_of(pkg, n_gpus, tp, pp):
    return pkg.build_comm_matrix(pkg.JobSpec(n_gpus=n_gpus, tp=tp, pp=pp, model=model7b(pkg)))


def fields(res) -> dict:
    out = dataclasses.asdict(res)
    assert type(res).__name__ == "SimResult"
    return out


def stack(pkg, seed, reserve=True, use_jct=True, jct_predictor=None, n_jobs=90,
          preemptable_frac=0.15, scheduler="mip"):
    """The reference's ``test_sim_parity`` replay stack."""
    cluster = pkg.Cluster.uniform(4, 16)
    policy = pkg.QueuePolicy(cluster, jct_predictor=jct_predictor, reserve=reserve,
                             use_jct=use_jct, scheduler=scheduler)
    sim = pkg.TraceSimulator(policy, tick=60.0)
    jobs = pkg.poisson_trace(n_jobs, mean_interarrival=40.0, mean_duration=700.0, max_nodes=16,
                             seed=seed, preemptable_frac=preemptable_frac)
    return sim, jobs


def replay_all(make, lpj=None, **run_kw):
    """Fast and legacy replays on both packages; all four ``SimResult``s
    must be equal.  ``make(pkg)`` builds a fresh stack, ``lpj(pkg)`` the
    LPJ plan tuple.  Returns the port's fast result."""
    out = []
    for pkg in PKGS:
        for legacy in (True, False):
            sim, jobs = make(pkg)
            kw = dict(run_kw, lpj_plan=lpj(pkg)) if lpj else run_kw
            out.append(sim.run(jobs, legacy=legacy, **kw))
    want = fields(out[0])
    for res in out[1:]:
        assert fields(res) == want
    return out[-1]


def lpj_32(pkg):
    return (comm_of(pkg, 32 * 8, 4, 4), 3000.0, 0.3, "pp")


class TestReplayParity:
    @pytest.mark.parametrize("seed", range(3))
    def test_no_lpj(self, seed):
        res = replay_all(lambda pkg: stack(pkg, seed), t_end=5000.0)
        assert len(res.queue_delays) > 0 and len(res.series) == 5000.0 // 60 + 1

    @pytest.mark.parametrize("seed", range(3))
    def test_lpj_reservation_and_backfill(self, seed):
        res = replay_all(lambda pkg: stack(pkg, seed), lpj_32, t_end=5000.0, plan_at=500.0)
        assert len(res.lpj_nodes) == 32 and any(p.retention_rate > 0 for p in res.series)

    def test_lpj_no_reservation(self):
        replay_all(lambda pkg: stack(pkg, 1, reserve=False), lpj_32, t_end=5000.0,
                   plan_at=500.0)

    def test_lpj_no_jct_backfill(self):
        replay_all(lambda pkg: stack(pkg, 2, use_jct=False), lpj_32, t_end=5000.0,
                   plan_at=500.0)

    def test_lpj_with_fitted_jct_predictor(self):
        preds = {}
        for pkg in PKGS:
            tj, jct = pkg.synthetic_trace(300, seed=5)
            preds[pkg] = pkg.JCTPredictor(n_bags=2, n_rounds=10).fit(tj, jct)
        replay_all(lambda pkg: stack(pkg, 3, jct_predictor=preds[pkg]), lpj_32,
                   t_end=5000.0, plan_at=500.0)

    def test_failures_trigger_replans(self):
        failures = [(700.0 + 100.0 * i, int(n)) for i, n in enumerate(range(0, 64, 9))]
        res = replay_all(lambda pkg: stack(pkg, 0), lpj_32, t_end=5000.0, plan_at=500.0,
                         failures=failures)
        assert res.failed_nodes == [n for _, n in failures] and res.lpj_replans >= 1

    def test_failure_replans_through_hier(self):
        """The churn path with a warm-start scheduler: each side's policy
        plans on a fresh "hier" instance."""
        failures = [(700.0 + 100.0 * i, int(n)) for i, n in enumerate(range(0, 64, 5))]
        res = replay_all(
            lambda pkg: stack(pkg, 1, scheduler=pkg.HierarchicalScheduler()), lpj_32,
            t_end=5000.0, plan_at=500.0, failures=failures)
        assert res.lpj_replans >= 1

    def test_preemptable_squatters_evicted_at_admission(self):
        res = replay_all(lambda pkg: stack(pkg, 4, preemptable_frac=0.9),
                         lambda pkg: (comm_of(pkg, 48 * 8, 4, 4), 2400.0, 0.3, "pp"),
                         t_end=5000.0, plan_at=300.0)
        assert res.preempted_at_lpj > 0

    def test_lpj_plan_with_scheduler_override(self):
        replay_all(lambda pkg: stack(pkg, 2),
                   lambda pkg: (comm_of(pkg, 32 * 8, 4, 4), 2000.0, 0.5, "dp", "topo-aware"),
                   t_end=3000.0, plan_at=100.0)

    def test_month_scale_shape_smoke(self):
        out = []
        for pkg in PKGS:
            policy = pkg.QueuePolicy(pkg.Cluster.uniform(8, 16))
            sim = pkg.TraceSimulator(policy, tick=300.0)
            jobs = pkg.poisson_trace(2000, mean_interarrival=120.0, mean_duration=800.0,
                                     max_nodes=32, seed=11)
            out.append(sim.run(jobs, t_end=2000 * 120.0 + 20000.0))
        assert fields(out[1]) == fields(out[0])
        res = out[1]
        assert len(res.series) == int((2000 * 120.0 + 20000.0) // 300.0) + 1
        assert len(res.queue_delays) >= 0.95 * 2000

    def test_trace_replay_appendix_h_shape(self):
        """The reference's ``tests/test_queue_jct.py::TestSimulator`` replay."""
        out = []
        for pkg in PKGS:
            sim = pkg.TraceSimulator(pkg.QueuePolicy(pkg.Cluster.uniform(4, 16)), tick=60.0)
            jobs = pkg.poisson_trace(40, mean_interarrival=50.0, mean_duration=600.0,
                                     max_nodes=16, seed=3)
            out.append(sim.run(jobs, t_end=4000.0, lpj_plan=lpj_32(pkg), plan_at=500.0))
        assert fields(out[1]) == fields(out[0])
        assert len(out[1].lpj_nodes) == 32 and len(out[1].series) > 10

    def test_faults_and_legacy_are_exclusive(self):
        for pkg in PKGS:
            sim, jobs = stack(pkg, 0)
            with pytest.raises(ValueError, match="vectorized"):
                sim.run(jobs, t_end=100.0, faults=[], legacy=True)


class TestPoissonTrace:
    @pytest.mark.parametrize("args", [(4000, 10.0, 100.0, 16, 0, 0.15),
                                      (500, 10.0, 100.0, 32, 3, 0.15),
                                      (1, 10.0, 100.0, 8, 1, 0.15),
                                      (300, 25.92, 2316.8, 256, 7, 0.5)])
    def test_same_jobs(self, args):
        ref, port = (pkg.poisson_trace(*args) for pkg in PKGS)
        assert [dataclasses.asdict(j) for j in port] == [dataclasses.asdict(j) for j in ref]
        assert all(isinstance(j.n_nodes, int) for j in port)
        sizes = {j.n_nodes for j in port}
        assert max(sizes) <= args[3]
        assert [j.arrival for j in port] == sorted(j.arrival for j in port)

    def test_max_size_jobs_generated(self):
        sizes = {j.n_nodes for j in P.poisson_trace(4000, 10.0, 100.0, 16, seed=0)}
        assert max(sizes) == 16 and sizes <= {1, 2, 4, 8, 16}


class TestThroughput:
    def test_throughput_of_placement(self):
        """mip against random-fit for a 2944-GPU job on paper setting iii:
        the same spreads, hop diameters, step times and breakdowns."""
        out = []
        for pkg in PKGS:
            cluster = pkg.Cluster.paper_setting("iii")
            comm = comm_of(pkg, 46 * 8 * 8, 8, 8)
            req = pkg.ScheduleRequest(comm=comm, cluster=cluster, alpha=0.3, seed=0)
            rows = []
            for name in ("mip", "random-fit", "topo-aware"):
                placement = pkg.get_scheduler(name).schedule(req).placement
                for kw in ({}, {"steps": 3, "seed": 4}, {"net": pkg.NetModel(), "mfu": 0.5}):
                    t = pkg.throughput_of_placement(placement, **kw)
                    rows.append(dict(t, breakdown=dataclasses.asdict(t["breakdown"])))
            out.append(rows)
        assert out[1] == out[0]
        good, bad = out[1][0], out[1][3]
        assert good["tokens_per_s"] > bad["tokens_per_s"] and 0 < good["comm_fraction"] < 1

    @pytest.mark.parametrize("kind", ["rail-only", "torus", "dragonfly"])
    def test_throughput_on_fabrics(self, kind):
        out = []
        for pkg in PKGS:
            topo = {R: RT, P: PT}[pkg]
            cluster = pkg.Cluster.from_fabric(topo.comparable_fabric(kind, [8] * 8))
            comm = comm_of(pkg, 96, 4, 2)
            placement = pkg.HierarchicalScheduler().schedule(
                pkg.ScheduleRequest(comm=comm, cluster=cluster, alpha=0.3)).placement
            t = pkg.throughput_of_placement(placement, steps=2, seed=1)
            out.append(dict(t, breakdown=dataclasses.asdict(t["breakdown"])))
        assert out[1] == out[0] and out[1]["fabric"] == kind


class TestBenchSim:
    """``bench_sim``'s parity trace and month through ``chip_smoke.py``'s
    replay functions, on both packages."""

    bench = json.loads((ROOT / "BENCH_sim.json").read_text())

    def test_parity_trace(self):
        ref, port = (CS.sim_parity(pkg, model7b(pkg)) for pkg in PKGS)
        want = self.bench["parity"]["checksum_fast"]
        assert ref["fast"] == ref["legacy"] == want
        assert port["fast"] == port["legacy"] == want
        # no LPJ solve in it was cut by a time limit: the pinned records
        assert ref["plans"] == ref["legacy_plans"] == CS.SIM_PARITY_PLANS
        assert port["plans"] == port["legacy_plans"] == CS.SIM_PARITY_PLANS
        assert port["replans"] == ref["replans"] == len(CS.SIM_PARITY_PLANS) - 1

    def test_month(self):
        (ref, _), (port, _) = (CS.sim_month(pkg) for pkg in PKGS)
        assert CS.sim_checksum(ref) == CS.SIM_MONTH_CHECKSUM
        assert CS.sim_checksum(port) == CS.SIM_MONTH_CHECKSUM
        assert port.queue_delays == ref.queue_delays
        assert fields(port) == fields(ref)
        assert len(port.series) == self.bench["metrics"]["series_points"] == 43201
        assert len(port.queue_delays) == self.bench["metrics"]["jobs_started"] == 100_000
        # np.mean's summation order is numpy's own (chip_smoke.py's simulate
        # phase): the recorded value is held against the exactly rounded sum
        assert port.mean_alloc() == ref.mean_alloc()
        rates = [p.allocation_rate for p in port.series]
        assert math.fsum(rates) / len(rates) == self.bench["metrics"]["mean_alloc"]
