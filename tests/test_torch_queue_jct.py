"""The port's JCT predictor (Appendix G) and queue policy (Algorithm 1)
against the reference's: the same fitted trees, the same predictions, and
the same queue, reservation and cluster state after the same sequence of
calls through ``repro.core`` and ``repro_torch.core``.  Every comparison
is exact (``==`` / ``np.array_equal``); "hier" runs as a fresh
``HierarchicalScheduler()`` on each side."""

import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.core.jct as RJ
import repro_torch.core as P
import repro_torch.core.jct as PJ

JCT = {R: RJ, P: PJ}
PKGS = (R, P)


def model7b(pkg):
    return pkg.ModelSpec(name="gpt-7b", hidden=4096, layers=32, vocab=50304, seq_len=2048,
                         global_batch=1024, micro_batch=1, d_ff=16384)


def comm_of(pkg, n_gpus, tp, pp):
    return pkg.build_comm_matrix(pkg.JobSpec(n_gpus=n_gpus, tp=tp, pp=pp, model=model7b(pkg)))


def same_tree(ref, port):
    assert [dataclasses.asdict(n) for n in port.nodes] == [dataclasses.asdict(n) for n in ref.nodes]


def same_gbm(ref, port):
    assert port.base_ == ref.base_
    assert len(port.trees_) == len(ref.trees_)
    for r, p in zip(ref.trees_, port.trees_):
        same_tree(r, p)


# ------------------------------------------------------------------- the GBM
class TestGBM:
    @pytest.mark.parametrize("depth,min_leaf", [(2, 5), (3, 8), (4, 2)])
    def test_tree_fits_step_function(self, depth, min_leaf):
        X = np.linspace(0, 1, 200).reshape(-1, 1)
        y = (X[:, 0] > 0.5).astype(float)
        ref = RJ.RegressionTree(max_depth=depth, min_leaf=min_leaf).fit(X, y)
        port = PJ.RegressionTree(max_depth=depth, min_leaf=min_leaf).fit(X, y)
        same_tree(ref, port)
        assert np.array_equal(port.predict(X), ref.predict(X))
        assert np.mean((port.predict(X) - y) ** 2) < 0.01

    def test_tree_with_ties_and_constant_features(self):
        rng = np.random.default_rng(4)
        X = np.column_stack([rng.integers(0, 4, 300), np.ones(300), rng.normal(size=300)])
        y = X[:, 0] * 2.0 + rng.normal(size=300)
        ref, port = (jct.RegressionTree(3, 8).fit(X, y) for jct in (RJ, PJ))
        same_tree(ref, port)
        assert np.array_equal(port.predict(X), ref.predict(X))

    @pytest.mark.parametrize("subsample", [0.8, 1.0, 0.05])
    def test_gbm_fit_and_predict(self, subsample):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(400, 4))
        y = 3 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.normal(size=400)
        ref, port = (jct.GBMRegressor(n_rounds=40, subsample=subsample, seed=3)
                     .fit(X[:300], y[:300]) for jct in (RJ, PJ))
        same_gbm(ref, port)
        assert np.array_equal(port.predict(X[300:]), ref.predict(X[300:]))
        if subsample == 0.8:
            mse = np.mean((port.predict(X[300:]) - y[300:]) ** 2)
            assert mse < 0.3 * np.mean((y[300:] - y[:300].mean()) ** 2)

    def test_synthetic_trace(self):
        for seed in (0, 1, 7):
            (rj, ry), (pj, py) = (pkg.synthetic_trace(300, seed=seed) for pkg in PKGS)
            assert pj == rj
            assert np.array_equal(py, ry) and py.dtype == ry.dtype

    def test_jct_predictor(self):
        """The reference's Appendix G experiment: 1500 synthetic jobs, a
        90/10 split, three bags of 40 rounds."""
        out = []
        for pkg in PKGS:
            jobs, jct = pkg.synthetic_trace(1500, seed=1)
            n_train = int(0.9 * len(jobs))
            pred = pkg.JCTPredictor(n_bags=3, n_rounds=40).fit(jobs[:n_train], jct[:n_train])
            test = jobs[n_train:]
            out.append((pred, pred.predict_bucket(test), pred.predict_seconds(test),
                        pred.uncertainty(test), pkg.JCTPredictor.featurize(test),
                        pkg.JCTPredictor.to_bucket(jct[n_train:])))
        (ref, *r_arrays), (port, *p_arrays) = out
        for r, p in zip(ref.models_, port.models_):
            same_gbm(r, p)
        for r, p in zip(r_arrays, p_arrays):
            assert np.array_equal(p, r) and p.dtype == r.dtype
        buckets, true_b = p_arrays[0], p_arrays[4]
        rmse = float(np.sqrt(np.mean((buckets - true_b) ** 2)))
        assert rmse < float(np.sqrt(np.mean((true_b - true_b.mean()) ** 2))) and rmse < 4.0
        assert PJ.JOB_FEATURES == RJ.JOB_FEATURES and PJ.BUCKET_SECONDS == RJ.BUCKET_SECONDS


# ------------------------------------------------------------ the queue policy
def queue_state(policy):
    """Everything the policy holds, in plain values."""
    lpj = policy.lpj
    return {
        "queue": [(key, j.job_id) for key, j in policy.queue],
        "running": {i: (j.start, list(j.nodes), j.in_reserved_zone)
                    for i, j in policy.running.items()},
        "reserved": sorted(policy.reserved_nodes()),
        "free": policy.cluster.free_mask_view().tolist(),
        "alloc": policy.allocation_rate(),
        "retention": policy.retention_rate(),
        "lpj": None if lpj is None else (lpj.arrival, lpj.alpha, lpj.beta, lpj.unit,
                                         None if lpj.result is None else
                                         (lpj.result.method, lpj.result.placement.node_ids())),
    }


def job_of(pkg, **kw):
    return pkg.Job(**kw)


def policy_of(pkg, reserve=True, use_jct=True, jct_predictor=None, scheduler=None):
    cluster = pkg.Cluster.uniform(4, 16)
    policy = pkg.QueuePolicy(cluster, reserve=reserve, use_jct=use_jct,
                             jct_predictor=jct_predictor,
                             scheduler=scheduler or "mip")
    policy.plan_lpj(comm_of(pkg, 32 * 8, 4, 4), arrival=1000.0, alpha=0.3)
    return policy


def run_both(script):
    """``script(pkg)`` returns a list of observations; both lists must be equal."""
    ref, port = script(R), script(P)
    assert port == ref
    return port


def started_ids(jobs):
    return [(j.job_id, list(j.nodes), j.in_reserved_zone) for j in jobs]


class TestQueuePolicy:
    def test_reservation_blocks_long_jobs(self):
        def script(pkg):
            policy = policy_of(pkg)
            policy.submit(job_of(pkg, job_id=1, n_nodes=40, arrival=0.0, duration=5000.0))
            return [started_ids(policy.schedule_tick(now=0.0)), queue_state(policy)]

        started, state = run_both(script)
        assert started == [] and len(state["queue"]) == 1 and len(state["reserved"]) == 32

    def test_short_job_backfills_reserved_zone(self):
        def script(pkg):
            policy = policy_of(pkg)
            policy.submit(job_of(pkg, job_id=2, n_nodes=40, arrival=0.0, duration=100.0))
            return [started_ids(policy.schedule_tick(now=0.0)), queue_state(policy)]

        started, _ = run_both(script)
        assert [s[0] for s in started] == [2] and started[0][2]

    def test_small_job_fits_outside(self):
        def script(pkg):
            policy = policy_of(pkg)
            policy.submit(job_of(pkg, job_id=3, n_nodes=8, arrival=0.0, duration=1e6))
            return [started_ids(policy.schedule_tick(now=0.0)), queue_state(policy)]

        started, _ = run_both(script)
        assert [s[0] for s in started] == [3] and not started[0][2]

    def test_admit_lpj_preempts(self):
        def script(pkg):
            policy = policy_of(pkg)
            policy.submit(job_of(pkg, job_id=4, n_nodes=40, arrival=0.0, duration=100.0))
            policy.schedule_tick(now=0.0)
            nodes, preempted = policy.admit_lpj(now=1000.0)
            return [nodes, [j.job_id for j in preempted], queue_state(policy)]

        nodes, preempted, _ = run_both(script)
        assert len(nodes) == 32 and preempted == [4]

    def test_rates_complete_and_requeue(self):
        def script(pkg):
            policy = policy_of(pkg)
            obs = [queue_state(policy)]
            policy.submit(job_of(pkg, job_id=5, n_nodes=40, arrival=0.0, duration=10.0))
            policy.submit(job_of(pkg, job_id=6, n_nodes=4, arrival=1.0, duration=10.0,
                                 priority=2))
            obs += [started_ids(policy.schedule_tick(now=0.0)), queue_state(policy)]
            policy.complete(5)
            obs.append(queue_state(policy))
            requeued = policy.requeue(6)
            obs += [(requeued.job_id, requeued.start, requeued.nodes), queue_state(policy)]
            obs += [started_ids(policy.schedule_tick(now=60.0)), queue_state(policy)]
            return obs

        obs = run_both(script)
        assert obs[2]["alloc"] == pytest.approx(44 / 64) and obs[3]["alloc"] == 4 / 64

    @pytest.mark.parametrize("reserve,use_jct", [(True, True), (True, False), (False, True)])
    def test_many_ticks(self, reserve, use_jct):
        """A seeded stream of jobs through ticks, completions and the LPJ's
        admission, with the GBM predicting JCTs."""
        def script(pkg):
            tj, jct = pkg.synthetic_trace(200, seed=5)
            pred = pkg.JCTPredictor(n_bags=2, n_rounds=8).fit(tj, jct)
            policy = policy_of(pkg, reserve=reserve, use_jct=use_jct, jct_predictor=pred)
            jobs = pkg.poisson_trace(60, mean_interarrival=15.0, mean_duration=400.0,
                                     max_nodes=16, seed=2, preemptable_frac=0.3)
            obs, ai = [], 0
            for tick in range(25):
                now = 60.0 * tick
                while ai < len(jobs) and jobs[ai].arrival <= now:
                    policy.submit(jobs[ai])
                    ai += 1
                for j in list(policy.running.values()):
                    if j.start + j.duration <= now:
                        policy.complete(j.job_id)
                if now == 1020.0:
                    obs.append(policy.admit_lpj(now)[0])
                obs += [started_ids(policy.schedule_tick(now)), queue_state(policy)]
            return obs

        run_both(script)

    def test_legacy_tick_matches_batched_tick(self):
        def script(pkg):
            rng = np.random.default_rng(9)
            obs = []
            for _ in range(4):
                policies = [pkg.QueuePolicy(pkg.Cluster.uniform(3, 8), reserve=False)
                            for _ in range(2)]
                spec = [dict(job_id=i, n_nodes=int(rng.integers(1, 9)), arrival=0.0,
                             duration=100.0, priority=int(rng.integers(0, 3)),
                             preemptable=bool(rng.random() < 0.3)) for i in range(20)]
                for pol in policies:
                    for kw in spec:
                        pol.submit(pkg.Job(**kw))
                legacy = started_ids(policies[0].schedule_tick_legacy(now=0.0))
                batched = started_ids(policies[1].schedule_tick(now=0.0))
                assert legacy == batched
                obs += [batched, queue_state(policies[1])]
            return obs

        run_both(script)

    def test_replan_lpj(self):
        def script(pkg):
            policy = policy_of(pkg, scheduler=pkg.HierarchicalScheduler())
            victims = sorted(policy.reserved_nodes())[:2]
            res = policy.replan_lpj(dirty_nodes=frozenset(victims))
            return [res.method, res.placement.node_ids(), queue_state(policy)]

        method, nodes, _ = run_both(script)
        assert method == "hier-warm" and len(nodes) == 32

    def test_replan_requires_plan(self):
        for pkg in PKGS:
            with pytest.raises(ValueError, match="no planned LPJ"):
                pkg.QueuePolicy(pkg.Cluster.uniform(4, 8)).replan_lpj(dirty_nodes=frozenset([0]))


class TestQueueIntegration:
    """The reference's ``tests/test_scheduler.py::TestQueueIntegration``."""

    def test_queue_policy_takes_scheduler_by_name(self):
        def script(pkg):
            policy = pkg.QueuePolicy(pkg.Cluster.uniform(4, 8), scheduler="mip,topo-aware")
            res = policy.plan_lpj(comm_of(pkg, 96, 4, 2), arrival=100.0, alpha=0.3)
            return [type(res).__name__, res.method, res.stats.get("served_by"),
                    res.placement.node_ids(), queue_state(policy)]

        _, _, served_by, nodes, _ = run_both(script)
        assert served_by == "mip" and len(nodes) == 12

    def test_plan_lpj_per_call_override(self):
        def script(pkg):
            policy = pkg.QueuePolicy(pkg.Cluster.uniform(4, 8))
            res = policy.plan_lpj(comm_of(pkg, 96, 4, 2), arrival=100.0, alpha=0.3,
                                  scheduler="gpu-packing")
            return [res.method, res.placement.node_ids(), queue_state(policy)]

        assert run_both(script)[0] == "gpu-packing"

    def test_simulator_lpj_plan_carries_scheduler(self):
        def script(pkg):
            policy = pkg.QueuePolicy(pkg.Cluster.uniform(4, 8))
            sim = pkg.TraceSimulator(policy, tick=60.0)
            res = sim.run([], t_end=300.0,
                          lpj_plan=(comm_of(pkg, 96, 4, 2), 200.0, 0.3, "pp", "topo-aware"),
                          plan_at=0.0)
            return [res.lpj_nodes, policy.lpj.result.method, len(res.series)]

        nodes, method, _ = run_both(script)
        assert len(nodes) == 12 and method == "topo-aware"


class TestFailureManager:
    """The reference's ``tests/test_queue_jct.py::TestFailureManager``."""

    @staticmethod
    def _placed(pkg, n_pods, per_pod, n_gpus, tp, pp):
        cluster = pkg.Cluster.uniform(n_pods, per_pod)
        res = pkg.get_scheduler("mip").schedule(pkg.ScheduleRequest(
            comm=comm_of(pkg, n_gpus, tp, pp), cluster=cluster, alpha=0.3))
        cluster.allocate(res.placement.node_ids())
        return cluster, res.placement

    def test_backup_promotion_keeps_spread(self):
        def script(pkg):
            cluster, placement = self._placed(pkg, 4, 20, 32 * 8, 4, 4)
            before = pkg.max_spreads(placement)
            fm = pkg.FailureManager(placement, cluster, backup_frac=0.1)
            pods = {p for p, b in fm.backups.items() if b}
            victim = next(n for n in placement.node_ids() if cluster.nodes[n].minipod in pods)
            ev = fm.on_failure(victim)
            assert (ev.dp_spread_after, ev.pp_spread_after) == before
            return [fm.backup_count(), dict(fm.backups), dataclasses.asdict(ev),
                    placement.assignment.tolist(), cluster.free_mask_view().tolist()]

        assert run_both(script)[2]["kind"] == "backup"

    def test_cross_pod_fallback(self):
        def script(pkg):
            cluster, placement = self._placed(pkg, 2, 8, 12 * 8, 4, 2)
            fm = pkg.FailureManager(placement, cluster, backup_frac=0.01)
            obs = []
            for v in placement.node_ids()[:4]:
                try:
                    obs.append(dataclasses.asdict(fm.on_failure(v)))
                except pkg.Infeasible as exc:
                    obs.append(str(exc))
                    break
            return obs + [placement.assignment.tolist(), cluster.free_mask_view().tolist()]

        obs = run_both(script)
        assert {o["kind"] for o in obs if isinstance(o, dict)} <= {"backup", "local", "cross-pod"}

    def test_straggler_swap(self):
        def script(pkg):
            cluster, placement = self._placed(pkg, 4, 20, 32 * 8, 4, 4)
            fm = pkg.FailureManager(placement, cluster, backup_frac=0.2)
            ev = fm.on_straggler(placement.node_ids()[5])
            return [None if ev is None else dataclasses.asdict(ev),
                    [dataclasses.asdict(e) for e in fm.events], placement.assignment.tolist()]

        ev = run_both(script)[0]
        assert ev is None or ev["kind"] == "backup"
