"""The port's fault subsystem against the reference's: seeded fault traces
and their digests on every fabric family, the elastic repair ladder tier by
tier, the ladder behind the ``Scheduler`` contract, goodput accounting,
``FailureManager``, and ``TraceSimulator.run(faults=...)`` under the
"elastic", "full" and "never" policies -- at ``bench_faults``'s smoke size
and, for "elastic" and "never", at its month (9984 nodes, 20 000 jobs, a
4096-node LPJ), whose digests are held equal to ``BENCH_faults.json`` and
to the constants ``chip_smoke.py`` pins.

Every comparison is exact.  Placement solves run on fresh
``HierarchicalScheduler()``s (the registry's keeps its cache across test
files), each recorded, so a digest is compared only after every solve in
the replay is shown to be one that no time limit cut."""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as R
import repro.faults as RF
import repro.faults.model as RFM
import repro.topo as RT
import repro_torch.core as P
import repro_torch.faults as PF
import repro_torch.faults.model as PFM
import repro_torch.topo as PT

ROOT = Path(__file__).resolve().parents[1]
PKGS = (R, P)
FAULTS = {R: RF, P: PF}
TOPO = {R: RT, P: PT}


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = chip_smoke()
# solves whose result does not depend on a time limit
EXACT_METHODS = {"greedy-proven-optimal", "hier-warm", "topo-aware"}


def model7b(pkg):
    return pkg.ModelSpec(**CS.PLACE_MODEL7B)


def comm_of(pkg, rows=4, cols=2):
    """rows x cols node grid: tp=8 (one TP group per node), pp=cols."""
    return pkg.build_comm_matrix(pkg.JobSpec(n_gpus=rows * cols * 8, tp=8, pp=cols,
                                             model=model7b(pkg)))


def run_both(script):
    ref, port = script(R), script(P)
    assert port == ref
    return port


def events_of(events):
    assert all(type(e).__name__ == "FaultEvent" for e in events)
    return [dataclasses.asdict(e) for e in events]


def fresh_chain(pkg):
    return CS.RecordingScheduler(pkg.FallbackChain(pkg.HierarchicalScheduler(), "mip",
                                                   "topo-aware"))


def solves_are_exact(records):
    for method, served_by, coarse, fine in records:
        assert method in EXACT_METHODS | {"hier"}, method
        if method == "hier":
            assert {coarse, *fine} <= {"greedy-proven-optimal", "flat"}, (coarse, fine)


# ---------------------------------------------------------------------------
# Fault model
# ---------------------------------------------------------------------------
FABRICS = {
    "clos": ("clos", ([8] * 4,), {}),
    "clos-big": ("clos", ([96] * 20,), {}),
    "rail-only": ("rail-only", ([8] * 6,), {}),
    "torus": ("torus", ((2, 4),), {"nodes_per_domain": 4}),
    "dragonfly": ("dragonfly", (3,), {"routers_per_group": 2, "nodes_per_router": 4}),
}
HOT = dict(node_mtbf_s=5 * 86400.0, straggler_mtbf_s=10 * 86400.0, domain_mtbf_s=50 * 86400.0)
CONFIGS = {"default": {}, "hot": HOT,
           "domains-off": dict(domain_mtbf_s=0.0, straggler_mtbf_s=0.0),
           "custom": dict(transient_frac=0.3, mean_ttr_s=600.0, min_ttr_s=30.0,
                          straggler_slowdown=(1.5, 2.0), node_mtbf_s=20 * 86400.0)}


def fabric(pkg, key):
    kind, args, kwargs = FABRICS[key]
    return TOPO[pkg].get_fabric(kind, *args, **kwargs)


class TestFaultModel:
    @pytest.mark.parametrize("config", sorted(CONFIGS))
    @pytest.mark.parametrize("key", sorted(FABRICS))
    def test_same_trace_and_digest(self, key, config):
        out = []
        for pkg in PKGS:
            fm = FAULTS[pkg].FaultModel(seed=7, **CONFIGS[config])
            events = fm.generate(fabric(pkg, key), 30 * 86400.0)
            assert fm.generate(fabric(pkg, key), 30 * 86400.0) == events
            out.append((events_of(events), FAULTS[pkg].trace_digest(events),
                        dataclasses.asdict(fm.config)))
        assert out[1] == out[0]
        assert out[1][0], "a month on these fabrics has faults"

    def test_seeds_differ_and_kinds(self):
        f = fabric(P, "clos")
        assert PF.trace_digest(PF.FaultModel(seed=8).generate(f, 30 * 86400.0)) != \
            PF.trace_digest(PF.FaultModel(seed=7).generate(f, 30 * 86400.0))
        assert PFM.KINDS == RFM.KINDS

    def test_events_well_formed(self):
        f = fabric(P, "clos")
        events = PF.FaultModel(seed=1).generate(f, 90 * 86400.0)
        assert [e.t for e in events] == sorted(e.t for e in events)
        for e in events:
            assert 0.0 <= e.t < 90 * 86400.0 and e.kind in PFM.KINDS
            assert e.nodes and all(0 <= n < f.n_nodes for n in e.nodes)
            if e.kind == "domain":
                assert set(e.nodes) <= set(f.domain_nodes(e.domain))
            if e.kind == "straggler":
                assert e.slowdown > 1.0
            if e.transient:
                assert e.ttr_s > 0.0

    def test_domain_blast_radius_follows_fabric(self):
        out = []
        for pkg in PKGS:
            f = TOPO[pkg].TorusFabric((2, 4), nodes_per_domain=4)
            events = [e for e in FAULTS[pkg].FaultModel(seed=3, domain_mtbf_s=86400.0)
                      .generate(f, 30 * 86400.0) if e.kind == "domain"]
            assert events and all(len(e.nodes) > 1 for e in events)
            out.append(events_of(events))
        assert out[1] == out[0]

    def test_digest_is_over_every_field(self):
        e = PF.FaultEvent(t=1.0, kind="node", nodes=(3,), transient=True, ttr_s=5.0)
        moved = dataclasses.replace(e, ttr_s=np.nextafter(5.0, 6.0))
        assert PF.trace_digest([e]) != PF.trace_digest([moved])
        assert PF.trace_digest([e]) == RF.trace_digest(
            [RF.FaultEvent(t=1.0, kind="node", nodes=(3,), transient=True, ttr_s=5.0)])

    def test_bad_configs_raise(self):
        for pkg in PKGS:
            with pytest.raises(ValueError, match="node_mtbf_s"):
                FAULTS[pkg].FaultModelConfig(node_mtbf_s=0.0)
            with pytest.raises(ValueError, match="straggler_slowdown"):
                FAULTS[pkg].FaultModelConfig(straggler_slowdown=(0.5, 2.0))
            with pytest.raises(ValueError, match="kind"):
                FAULTS[pkg].FaultEvent(t=0.0, kind="fire", nodes=(1,))


# ---------------------------------------------------------------------------
# The escalation ladder
# ---------------------------------------------------------------------------
def place(pkg, cluster, comm, **kw):
    """Schedule through "topo-aware" and allocate, as QueuePolicy does for
    an admitted LPJ, then bind the ladder."""
    res = pkg.get_scheduler("topo-aware").schedule(
        pkg.ScheduleRequest(comm=comm, cluster=cluster, alpha=0.5, unit="pp"))
    cluster.allocate(res.placement.node_ids())
    return FAULTS[pkg].BoundRepair(res.placement, cluster, **kw)


def outcome_of(o):
    return None if o is None else dataclasses.asdict(o)


def bound_state(bound):
    return {"placed": sorted(bound.placed), "dead": sorted(bound.dead),
            "backups": {d: list(v) for d, v in bound.backups.items()},
            "capacity": bound.capacity, "shrunk": bound.shrunk_rows,
            "grown": bound.grown_rows, "assignment": bound.placement.assignment.tolist(),
            "comm": bound.placement.comm.shape,
            "outcomes": [outcome_of(o) for o in bound.outcomes],
            "free": bound.cluster.free_mask_view().tolist()}


def exhaust(cluster):
    grabbed = []
    for d in range(cluster.n_domains):
        free = cluster.free_in_domain(d)
        cluster.allocate(free)
        grabbed.extend(int(n) for n in free)
    return grabbed


class TestEscalationLadder:
    def test_backup_tier_and_replenish(self):
        def script(pkg):
            cluster = pkg.Cluster.uniform(4, 16)
            bound = place(pkg, cluster, comm_of(pkg), backup_frac=0.2)
            before = bound_state(bound)
            outcome = bound.repair([int(bound.placement.assignment[0, 0])], now=100.0)
            return [before, outcome_of(outcome), bound_state(bound), bound.backup_count()]

        _, outcome, _, backups = run_both(script)
        assert outcome["tier"] == "backup" and outcome["lost_work_s"] > 0 and backups >= 1

    def test_domain_tier(self):
        def script(pkg):
            cluster = pkg.Cluster.uniform(4, 16)
            bound = place(pkg, cluster, comm_of(pkg), backup_frac=0.0)
            outcome = bound.repair([int(bound.placement.assignment[0, 0])], now=0.0)
            return [outcome_of(outcome), bound_state(bound)]

        assert run_both(script)[0]["tier"] == "domain"

    def test_warm_tier_when_domain_full(self):
        def script(pkg):
            cluster = pkg.Cluster.uniform(4, 16)
            bound = place(pkg, cluster, comm_of(pkg), backup_frac=0.0)
            victim = int(bound.placement.assignment[0, 0])
            cluster.allocate(cluster.free_in_domain(cluster.domain_of(victim)))
            return [outcome_of(bound.repair([victim], now=0.0)), bound_state(bound)]

        assert run_both(script)[0]["tier"] == "warm"

    def test_shrink_then_grow(self):
        def script(pkg):
            cluster = pkg.Cluster.uniform(4, 16)
            bound = place(pkg, cluster, comm_of(pkg), backup_frac=0.0)
            grabbed = exhaust(cluster)
            obs = [outcome_of(bound.repair([int(bound.placement.assignment[1, 0])], now=0.0)),
                   bound_state(bound), bound.placement.comm.job.n_gpus]
            obs.append(outcome_of(bound.grow(now=5.0)))        # pool still dry
            cluster.release(grabbed[:2])
            obs += [outcome_of(bound.grow(now=10.0)), bound_state(bound), bound.can_grow()]
            return obs

        shrink, state, n_gpus, dry, grow, after, can_grow = run_both(script)
        assert shrink["tier"] == "shrink" and state["capacity"] == 3 / 4 and n_gpus == 48
        assert dry is None and grow["tier"] == "grow" and grow["lost_work_s"] == 0.0
        assert after["capacity"] == 1.0 and not can_grow

    def test_restart_tier_via_cascade(self):
        def script(pkg):
            cluster = pkg.Cluster.uniform(4, 16)
            spare: list[int] = []

            def claimer(n, domain=None):
                freed = spare[:n]
                del spare[:n]
                cluster.release(freed)
                return freed

            bound = place(pkg, cluster, comm_of(pkg), backup_frac=0.0, enable_shrink=False,
                          forced_tier="restart", inner=pkg.get_scheduler("topo-aware"))
            spare.extend(exhaust(cluster))
            victim = int(bound.placement.assignment[0, 0])
            with pytest.raises(pkg.Infeasible) as info:
                bound.repair([victim], now=0.0)
            obs = [str(info.value), bound_state(bound)]
            bound.claimer = claimer
            obs += [outcome_of(bound.repair([victim], now=0.0)), bound_state(bound)]
            return obs

        _, _, outcome, _ = run_both(script)
        assert outcome["tier"] == "restart"
        assert outcome["downtime_s"] > PF.RepairCosts().reload_s()

    def test_max_tier_warm_raises(self):
        def script(pkg):
            cluster = pkg.Cluster.uniform(4, 16)
            bound = place(pkg, cluster, comm_of(pkg), backup_frac=0.0, max_tier="warm")
            exhaust(cluster)
            with pytest.raises(pkg.Infeasible) as info:
                bound.repair([int(bound.placement.assignment[0, 0])], now=0.0)
            return [str(info.value), bound_state(bound)]

        run_both(script)

    def test_correlated_blast_is_one_event(self):
        def script(pkg):
            cluster = pkg.Cluster.uniform(4, 16)
            bound = place(pkg, cluster, comm_of(pkg), backup_frac=0.0)
            a = bound.placement.assignment
            pod0 = cluster.domain_of(int(a[0, 0]))
            blast = [int(n) for n in a.ravel() if cluster.domain_of(int(n)) == pod0]
            return [outcome_of(bound.repair(blast, now=0.0)), bound_state(bound)]

        outcome, _ = run_both(script)
        assert outcome["lost_work_s"] == PF.RepairCosts().lost_work_s()

    @pytest.mark.parametrize("backup_frac,escalate", [(0.2, True), (0.0, True),
                                                      (0.0, False)])
    def test_straggler(self, backup_frac, escalate):
        def script(pkg):
            cluster = pkg.Cluster.uniform(4, 16)
            bound = place(pkg, cluster, comm_of(pkg), backup_frac=backup_frac)
            slow = int(bound.placement.assignment[0, 0])
            outcome = bound.on_straggler(slow, now=0.0, escalate=escalate)
            return [outcome_of(outcome), bound_state(bound), cluster.is_free(slow)]

        outcome, _, freed = run_both(script)
        if escalate:
            assert outcome["tier"] in ("backup", "domain", "warm") and freed
            assert outcome["lost_work_s"] == 0.0
        else:
            assert outcome is None

    def test_bad_max_tier_and_costs(self):
        for pkg in PKGS:
            cluster = pkg.Cluster.uniform(4, 16)
            with pytest.raises(ValueError, match="max_tier"):
                place(pkg, cluster, comm_of(pkg), max_tier="pray")
        assert dataclasses.asdict(PF.RepairCosts()) == dataclasses.asdict(RF.RepairCosts())
        assert PF.TIERS == RF.TIERS

    @pytest.mark.parametrize("kind", ["rail-only", "torus", "dragonfly"])
    def test_ladder_on_fabric(self, kind):
        """A run of failures through backup, domain and warm tiers on each
        non-clos fabric: candidates ordered by hop distance."""
        def script(pkg):
            cluster = pkg.Cluster.from_fabric(TOPO[pkg].comparable_fabric(kind, [8] * 8))
            bound = place(pkg, cluster, comm_of(pkg, 6, 2), backup_frac=0.1)
            obs = []
            for i in range(6):
                victim = int(bound.placement.assignment[i, i % 2])
                if i == 3:
                    cluster.allocate(cluster.free_in_domain(cluster.domain_of(victim)))
                try:
                    obs.append(outcome_of(bound.repair([victim], now=100.0 * i)))
                except pkg.Infeasible as exc:
                    obs.append(str(exc))
            return obs + [bound_state(bound)]

        run_both(script)


# ---------------------------------------------------------------------------
# The ladder behind the Scheduler contract
# ---------------------------------------------------------------------------
def elastic(pkg):
    """The registered policy's class, on a fresh inner chain."""
    cls = type(pkg.get_scheduler("elastic"))
    return cls(inner=pkg.FallbackChain(pkg.HierarchicalScheduler(), "mip", "topo-aware"))


def result_of(res):
    stats = {k: v for k, v in res.stats.items() if k not in ("counts", "cache")}
    return [res.method, res.placement.assignment.tolist(), res.objective, res.dp_spread,
            res.pp_spread, stats]


class TestElasticSchedulerContract:
    def test_registered_in_each_registry(self):
        assert type(P.get_scheduler("elastic")) is PF.ElasticRepairPolicy
        assert type(R.get_scheduler("elastic")) is RF.ElasticRepairPolicy
        for name, cls in (("elastic", "ElasticRepairPolicy"), ("full", "FullResolveRepair"),
                          ("full_resolve", "FullResolveRepair"), ("Never", "NeverRepair")):
            assert type(PF.get_repair_policy(name)).__name__ == cls
        with pytest.raises(KeyError, match="unknown repair policy"):
            PF.get_repair_policy("pray")
        with pytest.raises(TypeError):
            PF.get_repair_policy(3)

    def test_cold_request_delegates(self):
        def script(pkg):
            res = elastic(pkg).schedule(pkg.ScheduleRequest(comm=comm_of(pkg),
                                                            cluster=pkg.Cluster.uniform(4, 8)))
            return result_of(res)

        method = run_both(script)[0]
        assert not method.startswith("elastic")

    @pytest.mark.parametrize("n_dirty,fill", [(1, False), (2, True), (3, False)])
    def test_warm_request_runs_ladder(self, n_dirty, fill):
        def script(pkg):
            cluster = pkg.Cluster.uniform(4, 8)
            comm, sched = comm_of(pkg), elastic(pkg)
            cold = sched.schedule(pkg.ScheduleRequest(comm=comm, cluster=cluster))
            cluster.allocate(cold.placement.node_ids())
            dirty = [int(n) for n in cold.placement.assignment.ravel()[:n_dirty]]
            if fill:
                cluster.allocate(cluster.free_in_domain(cluster.domain_of(dirty[0])))
            warm = sched.schedule(pkg.ScheduleRequest(
                comm=comm, cluster=cluster, prev_placement=cold.placement,
                dirty_nodes=frozenset(dirty)))
            return [result_of(cold), result_of(warm)]

        _, warm = run_both(script)
        assert warm[0].startswith("elastic-") and warm[5]["repair"]["tier"] in PF.TIERS

    def test_full_resolve_contract(self):
        def script(pkg):
            cluster = pkg.Cluster.uniform(4, 8)
            sched = FAULTS[pkg].FullResolveRepair(
                inner=pkg.FallbackChain(pkg.HierarchicalScheduler(), "mip", "topo-aware"))
            cold = sched.schedule(pkg.ScheduleRequest(comm=comm_of(pkg), cluster=cluster))
            return result_of(cold)

        run_both(script)


# ---------------------------------------------------------------------------
# Goodput accounting
# ---------------------------------------------------------------------------
def outcome(faults, t, downtime, lost, capacity=1.0):
    return faults.RepairOutcome(t=t, tier="backup", failed=(0,), replacements=(1,),
                                tiers=("backup",), downtime_s=downtime, lost_work_s=lost,
                                migration_s=0.0, capacity=capacity)


class TestGoodputTracker:
    SCRIPTS = {
        "slowdown-repair": [("start", 0.0), ("set_slowdown", 2.0, 100.0),
                            ("add_repair", 200.0, 50.0, 30.0), ("set_slowdown", 1.0, 250.0)],
        "halt-resume": [("start", 0.0), ("halt", 100.0), ("resume", 300.0)],
        "capacity": [("start", 0.0), ("add_repair", 100.0, 0.0, 0.0, 0.75)],
        "mixed": [("start", 17.5), ("set_slowdown", 1.7, 33.3),
                  ("add_repair", 90.1, 12.25, 450.0, 0.875), ("halt", 120.0),
                  ("advance", 130.0), ("resume", 170.3), ("set_slowdown", 0.5, 171.0),
                  ("add_repair", 300.0, 1e3, 1.5), ("halt", 390.0)],
    }

    @pytest.mark.parametrize("key", sorted(SCRIPTS))
    def test_same_stats(self, key):
        def script(pkg):
            faults = FAULTS[pkg]
            tr = faults.GoodputTracker()
            for name, *args in self.SCRIPTS[key]:
                if name == "add_repair":
                    tr.add_repair(outcome(faults, *args))
                else:
                    getattr(tr, name)(*args)
            stats = tr.finalize(400.0)
            return [dataclasses.asdict(stats), stats.elapsed_s, stats.goodput]

        stats, _, goodput = run_both(script)
        if key == "slowdown-repair":
            assert stats["effective_s"] == pytest.approx(100 + 50 - 30 + 150)
        if key == "halt-resume":
            assert stats["halted_s"] == 200.0
        assert 0.0 <= goodput <= 1.0

    def test_never_started_raises(self):
        for pkg in PKGS:
            with pytest.raises(ValueError, match="never started"):
                FAULTS[pkg].GoodputTracker().finalize(1.0)


# ---------------------------------------------------------------------------
# FailureManager over the port's ladder, on each fabric
# ---------------------------------------------------------------------------
class TestFailureManagerFabric:
    def test_torus_repair_prefers_nearest_domain(self):
        def script(pkg):
            f = TOPO[pkg].TorusFabric((2, 4), nodes_per_domain=4)
            cluster = pkg.Cluster(fabric=f)
            nodes = f.domain_nodes(0)
            placement = pkg.Placement(comm=comm_of(pkg, 2, 2),
                                      assignment=np.array(nodes).reshape(2, 2), cluster=cluster)
            cluster.allocate(nodes)
            for d in (1, 4):
                cluster.allocate(f.domain_nodes(d))
            fm = pkg.FailureManager(placement, cluster, backup_frac=0.0)
            ev = fm.on_failure(nodes[0])
            return [dataclasses.asdict(ev), cluster.domain_of(ev.replacement),
                    placement.assignment.tolist()]

        ev, domain, _ = run_both(script)
        assert ev["kind"] == "cross-pod" and domain == 3

    @pytest.mark.parametrize("kind", ["clos", "rail-only", "torus", "dragonfly"])
    def test_failures_and_stragglers(self, kind):
        def script(pkg):
            cluster = pkg.Cluster.from_fabric(TOPO[pkg].comparable_fabric(kind, [8] * 8))
            res = pkg.get_scheduler("topo-aware").schedule(
                pkg.ScheduleRequest(comm=comm_of(pkg, 6, 2), cluster=cluster))
            cluster.allocate(res.placement.node_ids())
            fm = pkg.FailureManager(res.placement, cluster, backup_frac=0.1)
            obs = [fm.backup_count(), {d: list(v) for d, v in fm.backups.items()}]
            ids = res.placement.node_ids()
            ev = fm.on_straggler(ids[1])
            obs.append(None if ev is None else dataclasses.asdict(ev))
            for v in ids[2:7]:
                try:
                    obs.append(dataclasses.asdict(fm.on_failure(v)))
                except pkg.Infeasible as exc:
                    obs.append(str(exc))
            return obs + [[dataclasses.asdict(e) for e in fm.events],
                          res.placement.assignment.tolist(), cluster.free_mask_view().tolist()]

        run_both(script)

    def test_straggler_stays_backup_only(self):
        def script(pkg):
            cluster = pkg.Cluster.uniform(4, 8)
            res = pkg.get_scheduler("topo-aware").schedule(
                pkg.ScheduleRequest(comm=comm_of(pkg), cluster=cluster))
            cluster.allocate(res.placement.node_ids())
            fm = pkg.FailureManager(res.placement, cluster, backup_frac=0.0)
            return fm.on_straggler(int(res.placement.assignment[0, 0]))

        assert run_both(script) is None


# ---------------------------------------------------------------------------
# TraceSimulator.run(faults=...)
# ---------------------------------------------------------------------------
def sim_fields(res):
    assert type(res).__name__ == "SimResult"
    return dataclasses.asdict(res)


def small_setup(pkg, sched):
    """The reference's ``tests/test_faults.py`` stack: 4 x 8 nodes, 30
    jobs, a 16-GPU LPJ."""
    policy = pkg.QueuePolicy(pkg.Cluster.uniform(4, 8), scheduler=sched)
    sim = pkg.TraceSimulator(policy, tick=60.0)
    comm = pkg.build_comm_matrix(pkg.JobSpec(n_gpus=8 * 8, tp=8, pp=2, model=model7b(pkg)))
    jobs = pkg.poisson_trace(n_jobs=30, mean_interarrival=1800.0, mean_duration=3600.0,
                             max_nodes=8, seed=5)
    return sim, comm, jobs


def repair_policy(pkg, name, chain):
    """``name`` as a policy instance whose inner scheduler is ``chain``."""
    faults = FAULTS[pkg]
    return {"elastic": lambda: faults.ElasticRepairPolicy(inner=chain),
            "full": lambda: faults.FullResolveRepair(inner=chain),
            "never": faults.NeverRepair}[name]()


class TestSimulatorFaults:
    def _run(self, pkg, repair, seed=3):
        sched, inner = fresh_chain(pkg), fresh_chain(pkg)
        sim, comm, jobs = small_setup(pkg, sched)
        res = sim.run(jobs, t_end=2 * 86400.0, lpj_plan=(comm, 1800.0, 0.5, "pp"),
                      faults=FAULTS[pkg].FaultModel(seed=seed, **HOT),
                      repair=repair_policy(pkg, repair, inner))
        solves_are_exact(sched.records + inner.records)
        return sim_fields(res), sched.records, inner.records

    @pytest.mark.parametrize("repair", ["elastic", "full", "never"])
    def test_same_simresult(self, repair):
        port = run_both(lambda pkg: self._run(pkg, repair))[0]
        assert port == self._run(P, repair)[0]
        assert port["n_faults"] > 0 and 0.0 <= port["goodput"] <= 1.0

    def test_elastic_beats_never(self):
        e, n = self._run(P, "elastic")[0], self._run(P, "never")[0]
        assert e["goodput"] > n["goodput"] and sum(e["repair_tiers"].values()) > 0
        assert n["halted_s"] > 0 and not n["repair_tiers"]

    def test_pregenerated_trace_and_costs(self):
        def script(pkg):
            sched = fresh_chain(pkg)
            sim, comm, jobs = small_setup(pkg, sched)
            events = FAULTS[pkg].FaultModel(seed=4, **HOT).generate(sim.policy.cluster.fabric,
                                                                    86400.0)
            costs = FAULTS[pkg].RepairCosts(ckpt_interval_s=300.0, cold_solve_s=5.0)
            res = sim.run(jobs, t_end=86400.0, lpj_plan=(comm, 1800.0, 0.5, "pp"),
                          faults=events, repair="never", fault_costs=costs)
            return sim_fields(res)

        run_both(script)

    def test_faults_and_failures_are_exclusive(self):
        for pkg in PKGS:
            sim, _, jobs = small_setup(pkg, "topo-aware")
            with pytest.raises(ValueError, match="either"):
                sim.run(jobs, t_end=86400.0, faults=FAULTS[pkg].FaultModel(seed=0),
                        failures=[(100.0, 3)])

    def test_legacy_failures_shim_parity(self):
        def script(pkg):
            out = []
            for legacy in (False, True):
                sim, comm, jobs = small_setup(pkg, fresh_chain(pkg))
                out.append(sim_fields(sim.run(jobs, t_end=86400.0,
                                              lpj_plan=(comm, 3600.0, 0.5, "pp"),
                                              failures=[(2000.0, 4), (4000.0, 9)],
                                              legacy=legacy)))
            assert out[0] == out[1]
            return out[0]

        res = run_both(script)
        assert res["repair_tiers"] == {} and res["goodput"] is None

    @pytest.mark.parametrize("repair", ["elastic", "full", "never"])
    def test_bench_faults_smoke(self, repair):
        """``bench_faults``'s smoke size: 128 nodes, 200 jobs over 2 days, a
        32-node LPJ (TP 8, PP 8), its hot MTBFs; the policy by name, as the
        bench passes it."""
        kw = dict(n_pods=8, nodes_per_pod=16, n_jobs=200, days=2.0, lpj_nodes=32,
                  max_nodes=16, node_mtbf_s=5 * 86400.0, domain_mtbf_s=40 * 86400.0,
                  straggler_mtbf_s=10 * 86400.0)
        out = []
        for pkg in PKGS:
            res, _, digest, plans = CS.fault_replay(pkg, FAULTS[pkg], repair, model7b(pkg), **kw)
            solves_are_exact(plans)
            out.append((sim_fields(res), digest, CS.fault_checksum(res, digest), plans))
        assert out[1] == out[0]
        assert out[1][0]["n_faults"] > 0


class TestBenchFaultsMonth:
    """``bench_faults``'s month through ``chip_smoke.py``'s replay, on both
    packages: the fault trace's digest and the elastic digest equal to
    ``BENCH_faults.json``'s, both digests equal to the pinned constants,
    and every LPJ solve equal to the pinned record."""

    bench = json.loads((ROOT / "BENCH_faults.json").read_text())

    @pytest.mark.parametrize("repair,pinned", [("elastic", "FAULT_ELASTIC_CHECKSUM"),
                                               ("never", "FAULT_NEVER_CHECKSUM")])
    def test_month(self, repair, pinned):
        out = []
        for pkg in PKGS:
            res, _, digest, plans = CS.fault_replay(pkg, FAULTS[pkg], repair, model7b(pkg))
            assert plans == CS.FAULT_MONTH_PLANS   # no solve cut by a time limit
            solves_are_exact(plans)
            assert digest == self.bench["parity"]["fault_trace_digest"]
            assert CS.fault_checksum(res, digest) == getattr(CS, pinned)
            out.append(sim_fields(res))
        assert out[1] == out[0]
        if repair == "elastic":
            assert getattr(CS, pinned) == self.bench["parity"]["checksum_elastic"]
            assert out[1]["goodput"] == self.bench["metrics"]["goodput_elastic"]
            assert out[1]["repair_tiers"] == self.bench["repair_tiers"]
        else:
            assert out[1]["goodput"] == self.bench["metrics"]["goodput_never"]


def test_importing_the_port_leaves_the_reference_registry_alone():
    code = (
        "import repro.core as R, repro_torch.core as P\n"
        "before = (R.list_schedulers(), P.list_schedulers())\n"
        "import repro_torch.faults\n"
        "after = (R.list_schedulers(), P.list_schedulers())\n"
        "assert after[0] == before[0] and 'elastic' not in after[0], after\n"
        "assert after[1] == sorted(before[1] + ['elastic']), after\n"
        "import repro.faults\n"
        "assert 'elastic' in R.list_schedulers()\n"
        "assert type(P.get_scheduler('elastic')).__module__ == 'repro_torch.faults.repair'\n"
        "assert type(R.get_scheduler('elastic')).__module__ == 'repro.faults.repair'\n"
        "print('separate')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                                           "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "separate"
