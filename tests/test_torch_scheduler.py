"""The port's scheduling core against the reference's: every registered
policy, the MILP's internals, the "hier" tier's cold, warm and cached paths,
fallback chains and the deprecated shims, fed the same requests through
``repro.core`` and ``repro_torch.core``.

Placements, counts, objectives, methods and stats are compared exactly
(``==`` / ``np.array_equal``); only wall-clock fields are left out.  Every
MILP here finishes well inside its time budget, and each comparison asserts
the method first, so a solve cut by its limit fails by name.
"""

import time
import types

import numpy as np
import pytest

import repro.core as R
import repro.core.mip as RM
import repro_torch.core as P
import repro_torch.core.mip as PM

PKGS = (R, P)
MIP = {R: RM, P: PM}
ALPHA = 0.3
# the registry's built-in policies; the reference's ``repro.faults`` (not ported
# yet) adds "elastic" to its registry when imported, as its own tests import it
POLICIES = ("best-fit", "gpu-packing", "hier", "mip", "random-fit", "topo-aware")


def reference_builtins() -> list[str]:
    return [n for n in R.list_schedulers() if n != "elastic"]


def model7b(pkg):
    return pkg.ModelSpec(name="gpt-7b", hidden=4096, layers=32, vocab=50304, seq_len=2048,
                         global_batch=1024, micro_batch=1, d_ff=16384)


def comm_of(pkg, n_gpus, tp, pp, model=None):
    return pkg.build_comm_matrix(pkg.JobSpec(n_gpus=n_gpus, tp=tp, pp=pp,
                                             model=model or model7b(pkg)))


def cluster_of(pkg, spec, frag_seed=None, frag=0.3):
    if isinstance(spec, str):
        cluster = pkg.Cluster.paper_setting(spec)
    elif isinstance(spec, tuple) and len(spec) == 2 and isinstance(spec[0], int):
        cluster = pkg.Cluster.uniform(*spec)
    else:
        cluster = pkg.Cluster(list(spec))
    if frag_seed is not None:
        rng = np.random.default_rng(frag_seed)
        cluster.allocate(rng.choice(cluster.n_nodes, int(cluster.n_nodes * frag),
                                    replace=False).tolist())
    return cluster


# (cluster, fragmentation seed, (n_gpus, tp, pp), unit, alpha): paper
# settings i and iii, fragmented clusters, and a non-uniform one on which the
# greedy bound is not met and the MILP itself runs
PROBLEMS = {
    "i-pp": ("i", None, (96, 4, 2), "pp", ALPHA),
    "i-dp": ("i", None, (64, 8, 2), "dp", 0.7),
    "iii-pp": ("iii", None, (4096, 8, 8), "pp", ALPHA),
    "iii-dp": ("iii", None, (2048, 8, 4), "dp", 0.5),
    "iii-frag": ("iii", 1, (4096, 8, 8), "pp", ALPHA),
    "ii-frag": ("ii", 5, (1024, 4, 4), "pp", 0.5),
    "milp-pp": ((7, 5, 9, 3, 6), None, (160, 8, 4), "pp", ALPHA),
    "milp-dp": ((7, 5, 9, 3, 6), None, (160, 8, 4), "dp", ALPHA),
}


def problem(pkg, key):
    spec, frag, (n_gpus, tp, pp), unit, alpha = PROBLEMS[key]
    return comm_of(pkg, n_gpus, tp, pp), cluster_of(pkg, spec, frag), unit, alpha


def request(pkg, comm, cluster, **kw):
    return pkg.ScheduleRequest(comm=comm, cluster=cluster, **kw)


def scheduler(pkg, name):
    """The registry's policy; "hier" as a fresh instance, since the registry's
    keeps its placement cache across calls (and across test files)."""
    if name == "hier":
        return pkg.HierarchicalScheduler()
    return pkg.get_scheduler(name)


def assert_same_stats(ref: dict, port: dict):
    assert set(port) == set(ref)
    for key, want in ref.items():
        got = port[key]
        if isinstance(want, np.ndarray):
            assert np.array_equal(got, want) and got.dtype == want.dtype, key
        elif key == "fallbacks":
            assert [n for n, _ in got] == [n for n, _ in want]
            for (_, g), (_, w) in zip(got, want):
                if w.startswith("exceeded time budget"):   # carries the times
                    assert g.startswith("exceeded time budget")
                else:
                    assert g == w
        else:
            assert got == want, key


def assert_same_result(ref, port):
    assert port.method == ref.method
    assert np.array_equal(port.placement.assignment, ref.placement.assignment)
    assert port.placement.assignment.dtype == ref.placement.assignment.dtype
    assert port.objective == ref.objective
    assert (port.dp_spread, port.pp_spread) == (ref.dp_spread, ref.pp_spread)
    assert port.n_pods_used() == ref.n_pods_used()
    assert port.weighted_spread(ALPHA) == ref.weighted_spread(ALPHA)
    assert_same_stats(ref.stats, port.stats)


def both(fn):
    """``fn(pkg)`` for the reference and the port."""
    return fn(R), fn(P)


def same_error(fn, exc=None):
    """``fn(pkg)`` raises ``exc`` (the package's Infeasible by default) with
    the same message in both packages; returns the message."""
    msgs = []
    for pkg in PKGS:
        with pytest.raises(exc or pkg.Infeasible) as info:
            fn(pkg)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]
    return msgs[0]


class TestRegistry:
    def test_same_policies(self):
        assert P.list_schedulers() == reference_builtins() == list(POLICIES)

    @pytest.mark.parametrize("alias", ["milp", "arnold", "hierarchical", "scale", "topo_aware",
                                       "Best_Fit", " GPU-packing "])
    def test_aliases(self, alias):
        assert P.get_scheduler(alias).name == R.get_scheduler(alias).name
        assert P.get_scheduler(alias) is P.get_scheduler(P.get_scheduler(alias).name)

    def test_unknown_and_bad_specs(self):
        for pkg in PKGS:
            with pytest.raises(KeyError, match=r"unknown scheduler 'annealing'; available: \[") \
                    as info:
                pkg.get_scheduler("annealing")
            assert str(pkg.list_schedulers()) in str(info.value)
        with pytest.raises(TypeError):
            P.get_scheduler(3)
        with pytest.raises(ValueError):
            P.register_scheduler("mip", P.get_scheduler("mip"))
        with pytest.raises(ValueError):
            P.FallbackChain()

    def test_comma_chain(self):
        ref, port = both(lambda pkg: pkg.get_scheduler("mip, topo_aware,"))
        assert type(port).__name__ == "FallbackChain" and port.name == ref.name

    def test_registries_are_separate(self):
        name = "torch-scheduler-test-policy"
        from repro_torch.core import scheduler as port_scheduler

        P.register_scheduler(name, P.get_scheduler("best-fit"))
        try:
            assert name in P.list_schedulers() and name not in R.list_schedulers()
        finally:
            del port_scheduler._REGISTRY[name]
        assert P.list_schedulers() == reference_builtins()

    def test_request_validation(self):
        comm_cluster = lambda pkg: (comm_of(pkg, 96, 4, 2), cluster_of(pkg, "i"))
        same_error(lambda pkg: request(pkg, *comm_cluster(pkg), unit="tp"), ValueError)
        same_error(lambda pkg: request(pkg, *comm_cluster(pkg), alpha=-0.1), ValueError)


class TestEveryPolicy:
    @pytest.mark.parametrize("key", sorted(PROBLEMS))
    @pytest.mark.parametrize("name", POLICIES)
    def test_same_placement_objective_and_method(self, name, key):
        out = []
        for pkg in PKGS:
            comm, cluster, unit, alpha = problem(pkg, key)
            before = cluster.free_mask_view().copy()
            res = scheduler(pkg, name).schedule(request(pkg, comm, cluster, alpha=alpha,
                                                        unit=unit))
            assert np.array_equal(cluster.free_mask_view(), before)
            assert all(cluster.is_free(n) for n in res.placement.node_ids())
            out.append(res)
        ref, port = out
        if name in ("mip", "hier"):
            assert ref.method in ("milp", "greedy-proven-optimal", "hier"), ref.method
        if key.startswith("milp") and name in ("mip", "hier"):
            assert (ref.stats.get("fine_methods") or [ref.method]) == ["milp"]
        assert_same_result(ref, port)

    @pytest.mark.parametrize("name", POLICIES)
    def test_same_infeasible(self, name):
        for spec in [(2, 2), (2, 5)]:
            msg = same_error(lambda pkg: scheduler(pkg, name).schedule(
                request(pkg, comm_of(pkg, 96, 4, 2), cluster_of(pkg, spec))))
            assert msg

    @pytest.mark.parametrize("name", POLICIES)
    def test_excluded_and_reserved_nodes_restored(self, name):
        out = []
        for pkg in PKGS:
            comm, cluster = comm_of(pkg, 256, 8, 4), cluster_of(pkg, "iii", 7)
            free = cluster.free_node_ids()
            excluded = frozenset(free[::7].tolist()) | {int(cluster.n_nodes + 5)}
            reserved = frozenset(free[3::11].tolist())
            before = cluster.free_mask_view().copy()
            res = scheduler(pkg, name).schedule(request(
                pkg, comm, cluster, alpha=ALPHA, excluded_nodes=excluded,
                reserved_nodes=reserved, seed=11))
            assert np.array_equal(cluster.free_mask_view(), before)
            assert not (set(res.placement.node_ids()) & (excluded | reserved))
            out.append(res)
        assert_same_result(*out)


class TestRandomFit:
    @pytest.mark.parametrize("seed", [0, 1, 17])
    def test_same_seed(self, seed):
        ref, port = both(lambda pkg: pkg.get_scheduler("random-fit").schedule(
            request(pkg, comm_of(pkg, 512, 8, 4), cluster_of(pkg, "iii", 2), seed=seed)))
        assert_same_result(ref, port)

    def test_same_rng_and_its_state_after(self):
        gens = [np.random.default_rng(1234), np.random.default_rng(1234)]
        results = [pkg.get_scheduler("random-fit").schedule(request(
            pkg, comm_of(pkg, 96, 4, 2), cluster_of(pkg, "ii", 3), seed=99, rng=gen))
            for pkg, gen in zip(PKGS, gens)]
        assert_same_result(*results)
        assert gens[0].bit_generator.state == gens[1].bit_generator.state


class TestMipInternals:
    @pytest.mark.parametrize("integral", [True, False])
    @pytest.mark.parametrize("greedy", [True, False])
    @pytest.mark.parametrize("key", ["i-pp", "milp-pp", "milp-dp", "ii-frag"])
    def test_solve_counts(self, key, greedy, integral):
        out = []
        for pkg in PKGS:
            comm, cluster, unit, alpha = problem(pkg, key)
            n_groups = comm.n_rows if unit == "pp" else comm.n_cols
            size = comm.n_cols if unit == "pp" else comm.n_rows
            free = np.array(cluster.free_capacities(), dtype=float)
            counts, obj, _, method = MIP[pkg]._solve_counts(size, n_groups, free, alpha,
                                                       1 - alpha, integral, 30.0,
                                                       use_greedy_bound=greedy)
            out.append((counts, obj, method))
            assert method in ("milp", "greedy-proven-optimal", "greedy-incumbent")
        (c0, o0, m0), (c1, o1, m1) = out
        assert m1 == m0 and o1 == o0 and np.array_equal(c1, c0) and c1.dtype == c0.dtype

    def test_bounds_and_greedy_candidates(self):
        rm, pm = RM, PM
        rng = np.random.default_rng(0)
        for _ in range(60):
            k, size = int(rng.integers(1, 9)), int(rng.integers(1, 9))
            free = rng.integers(0, 20, size=k).astype(float)
            m = int(rng.integers(1, max(2, int(free.sum()) // size + 1)))
            a = float(rng.uniform(0, 1))
            if free.sum() >= size * m:
                assert pm._objective_lower_bound(size, m, free, a, 1 - a) == \
                    rm._objective_lower_bound(size, m, free, a, 1 - a)
            g, w = pm._greedy_whole(size, m, free), rm._greedy_whole(size, m, free)
            assert (g is None) == (w is None) and (g is None or np.array_equal(g, w))
            for q in range(1, k + 1):
                g = pm._greedy_sequential(size, m, free, q)
                w = rm._greedy_sequential(size, m, free, q)
                assert (g is None) == (w is None) and (g is None or np.array_equal(g, w))
            g, w = pm._greedy_candidates(size, m, free, a, 1 - a), \
                rm._greedy_candidates(size, m, free, a, 1 - a)
            assert g[1] == w[1] and (g[0] is None) == (w[0] is None)
            assert g[0] is None or np.array_equal(g[0], w[0])

    def test_round_counts(self):
        rm, pm = RM, PM
        rng = np.random.default_rng(3)
        for _ in range(40):
            m, k, size = int(rng.integers(1, 6)), int(rng.integers(2, 6)), int(rng.integers(2, 9))
            p = rng.dirichlet(np.ones(k), size=m)
            free = np.full(k, float(np.ceil(m * size / k) + rng.integers(0, 3)))
            try:
                want = rm._round_counts(p, size, free)
            except rm.Infeasible as exc:
                with pytest.raises(pm.Infeasible, match=str(exc)):
                    pm._round_counts(p, size, free)
                continue
            assert np.array_equal(pm._round_counts(p, size, free), want)

    def test_silence_stdout_restores_the_descriptors(self, capfd):
        from repro_torch.core.mip import _silence_stdout

        with _silence_stdout():
            import os

            os.write(1, b"muted\n")
            os.write(2, b"muted\n")
        print("after", flush=True)
        out, err = capfd.readouterr()
        assert "muted" not in out + err and "after" in out

    def test_solver_failure_degrades_to_topo_aware(self, monkeypatch):
        fail = lambda **kw: types.SimpleNamespace(x=None, status=1, message="time limit reached")
        monkeypatch.setattr(RM, "milp", fail)
        monkeypatch.setattr(PM, "milp", fail)
        out = []
        for pkg in PKGS:
            req = request(pkg, comm_of(pkg, 96, 4, 2), cluster_of(pkg, "i"), alpha=ALPHA,
                          time_budget=5.0, options={"use_greedy_bound": False})
            with pytest.raises(pkg.Infeasible, match="status=1 time limit reached"):
                pkg.get_scheduler("mip").schedule(req)
            out.append(pkg.FallbackChain("mip", "topo_aware").schedule(req))
        assert out[0].method == "topo-aware"
        assert_same_result(*out)


class _AlwaysInfeasible:
    """The reference's stand-in, for either package."""

    name = "always-infeasible"

    def __init__(self, pkg):
        self._pkg = pkg

    def schedule(self, request):
        raise self._pkg.Infeasible("synthetic failure")


class _Slow:
    """Valid result, delivered too late (the reference's stand-in)."""

    name = "slow"

    def __init__(self, pkg, delay: float):
        self._pkg, self._delay = pkg, delay

    def schedule(self, request):
        time.sleep(self._delay)
        return self._pkg.get_scheduler("topo-aware").schedule(request)


class TestFallbackChain:
    @pytest.mark.parametrize("links,budget,served_by,fallbacks", [
        (lambda pkg: ["mip", "topo-aware"], 10.0, "mip", None),
        (lambda pkg: [_AlwaysInfeasible(pkg), "topo-aware"], 10.0, "topo-aware",
         ["always-infeasible"]),
        (lambda pkg: [_Slow(pkg, 0.2), "topo-aware"], 0.05, "topo-aware", ["slow"]),
        (lambda pkg: [_Slow(pkg, 0.2), "mip", "topo-aware"], 0.05, "topo-aware",
         ["slow", "mip"]),
        (lambda pkg: [_Slow(pkg, 0.2)], 0.05, "slow", None),
        (lambda pkg: [pkg.HierarchicalScheduler(), "mip", "topo-aware"], 10.0, "hier", None),
    ], ids=["first-link", "infeasible", "overrun", "exhausted", "last-exempt", "hier"])
    def test_same_served_by_and_fallbacks(self, links, budget, served_by, fallbacks):
        out = []
        for pkg in PKGS:
            comm, cluster = comm_of(pkg, 96, 4, 2), cluster_of(pkg, "i")
            chain = pkg.FallbackChain(*links(pkg))
            res = chain.schedule(request(pkg, comm, cluster, alpha=ALPHA, time_budget=budget))
            assert res.stats["served_by"] == served_by
            assert [n for n, _ in res.stats.get("fallbacks", [])] == (fallbacks or [])
            out.append((chain.name, res))
        assert out[0][0] == out[1][0]
        assert_same_result(out[0][1], out[1][1])

    def test_all_links_fail_raises_the_same_aggregate(self):
        msg = same_error(lambda pkg: pkg.FallbackChain("mip", "topo_aware").schedule(
            request(pkg, comm_of(pkg, 96, 4, 2), cluster_of(pkg, (2, 2)))))
        assert "mip" in msg and "topo-aware" in msg


class TestHierarchical:
    def test_registered_instance(self):
        for alias in ("hier", "hierarchical", "scale"):
            assert type(P.get_scheduler(alias)).__name__ == "HierarchicalScheduler"

    @pytest.mark.parametrize("spec,job,ppb,blocks", [
        ((8, 8), (96, 4, 2), 2, 4),            # multi-block
        ((2, 6), (64, 8, 8), 1, 2),            # one 8-node group straddles two blocks
        ((24, 16), (1024, 8, 8), 4, 6),        # coarse MILP over six blocks
        ((104, 96), (4096, 8, 8), 16, 7),      # the reference's 10k-node cluster
    ], ids=["multi-block", "seam", "24-pods", "10k-nodes"])
    def test_cold_multi_block(self, spec, job, ppb, blocks):
        ref, port = both(lambda pkg: pkg.HierarchicalScheduler().schedule(request(
            pkg, comm_of(pkg, *job), cluster_of(pkg, spec), alpha=ALPHA, time_budget=30.0,
            options={"pods_per_block": ppb})))
        assert ref.method == "hier" and ref.stats["n_blocks"] == blocks
        assert ref.stats["coarse_method"] in ("milp", "greedy-proven-optimal")
        assert set(ref.stats["fine_methods"]) <= {"milp", "greedy-proven-optimal"}
        assert_same_result(ref, port)

    def test_seam_group_straddles_blocks(self):
        ref, port = both(lambda pkg: pkg.HierarchicalScheduler().schedule(request(
            pkg, comm_of(pkg, 64, 8, 8), cluster_of(pkg, (2, 6)), alpha=ALPHA,
            options={"pods_per_block": 1})))
        assert ref.stats["blocks_touched"] == 2 and ref.stats["fine_methods"] == []
        assert_same_result(ref, port)

    @pytest.mark.parametrize("spec,frag,ppb", [((24, 16), None, 4), ((24, 16), 4, 4),
                                               ((8, 16), 2, 16)])
    def test_warm_repair_then_cache_hit(self, spec, frag, ppb):
        """Cold solve, one placed node fails (warm repair), the same request
        again (cache hit), two nodes fail (repair across domains), and more
        dirty nodes than ``repair_max_dirty`` (cold again)."""
        runs = []
        for pkg in PKGS:
            sched = pkg.HierarchicalScheduler()
            comm, cluster = comm_of(pkg, 512, 8, 8), cluster_of(pkg, spec, frag)
            opts = {"pods_per_block": ppb}
            cold = sched.schedule(request(pkg, comm, cluster, alpha=ALPHA, time_budget=30.0,
                                          options=opts))
            ids = cold.placement.node_ids()
            victim = ids[0]
            warm = sched.schedule(request(
                pkg, comm, cluster, alpha=ALPHA, time_budget=30.0, options=opts,
                prev_placement=cold.placement, dirty_nodes={victim}, excluded_nodes={victim}))
            again = sched.schedule(request(pkg, comm, cluster, alpha=ALPHA, time_budget=30.0,
                                           options=opts))
            # fill the victim's domain so the repair must leave it
            pod = cluster.domain_of(ids[1])
            others = [n for n in cluster.free_in_domain(pod) if n not in ids]
            dirty = {ids[1], ids[2]}
            warm2 = sched.schedule(request(
                pkg, comm, cluster, alpha=ALPHA, time_budget=30.0, options=opts,
                prev_placement=cold.placement, dirty_nodes=dirty, excluded_nodes=dirty,
                reserved_nodes=others))
            many = set(ids[:9])
            recold = sched.schedule(request(
                pkg, comm, cluster, alpha=ALPHA, time_budget=30.0, options=opts,
                prev_placement=cold.placement, dirty_nodes=many, excluded_nodes=many))
            runs.append((cold, warm, again, warm2, recold, len(sched.cache),
                         sched.cache.stats.as_dict()))
        ref, port = runs
        assert [r.method for r in ref[:5]] == ["hier", "hier-warm", "hier-cached", "hier-warm",
                                               "hier"]
        assert ref[1].stats["repaired"][0][0] == ref[0].placement.node_ids()[0]
        for a, b in zip(ref[:5], port[:5]):
            assert_same_result(a, b)
        assert port[5:] == ref[5:]

    def test_cache_disabled_and_shape_change(self):
        runs = []
        for pkg in PKGS:
            sched = pkg.HierarchicalScheduler(pods_per_block=2,
                                              cache=pkg.PlacementCache(quantum=4, maxsize=2))
            cluster = cluster_of(pkg, (8, 8))
            out = [sched.schedule(request(pkg, comm_of(pkg, n, 4, 2), cluster, alpha=ALPHA,
                                          options={"use_cache": use}))
                   for n, use in ((96, False), (96, True), (96, True), (128, True), (64, True),
                                  (96, True))]
            runs.append((out, len(sched.cache), sched.cache.stats.as_dict()))
        assert [r.method for r in runs[0][0]] == ["hier", "hier", "hier-cached", "hier", "hier",
                                                  "hier"]
        for a, b in zip(runs[0][0], runs[1][0]):
            assert_same_result(a, b)
        assert runs[1][1:] == runs[0][1:]


class TestPlacementCache:
    def test_same_keys_lookups_and_eviction(self):
        runs = []
        for pkg in PKGS:
            cache = pkg.PlacementCache(quantum=4, maxsize=3)
            cluster = cluster_of(pkg, (5, 9))
            log = []
            for i, n in enumerate((96, 128, 96, 64, 160, 96)):
                comm = comm_of(pkg, n, 4, 2)
                key = cache.key(comm, cluster, "pp", ALPHA, 1 - ALPHA, extra=("i", i % 2))
                free = np.array(cluster.free_capacities())
                hit = cache.lookup(key, free)
                log.append((key, None if hit is None else hit.tolist()))
                if hit is None:
                    cache.store(key, np.full((comm.n_rows, cluster.n_domains), i))
                cluster.allocate(cluster.free_in_domain(i % 5)[:3])
            runs.append((log, len(cache), cache.stats.as_dict()))
            cache.clear()
            assert len(cache) == 0 and cache.stats.lookups == 0
        assert runs[1] == runs[0]
        same_error(lambda pkg: pkg.PlacementCache(quantum=0), ValueError)


class TestDeprecatedShims:
    def test_schedule_mip(self):
        out = []
        for pkg in PKGS:
            comm, cluster, unit, alpha = problem(pkg, "milp-pp")
            with pytest.warns(DeprecationWarning, match="get_scheduler"):
                out.append(pkg.schedule_mip(comm, cluster, alpha=alpha, unit=unit))
        ref, port = out
        assert ref.method == "milp"
        assert port.method == ref.method and port.objective == ref.objective
        assert (port.n_pods_used, port.max_unit_spread) == (ref.n_pods_used, ref.max_unit_spread)
        assert np.array_equal(port.counts, ref.counts)
        assert np.array_equal(port.placement.assignment, ref.placement.assignment)

    @pytest.mark.parametrize("shim", ["best_fit", "gpu_packing", "random_fit", "topo_aware"])
    def test_baseline_shims(self, shim):
        out = []
        for pkg in PKGS:
            with pytest.warns(DeprecationWarning, match="get_scheduler"):
                out.append(getattr(pkg, shim)(comm_of(pkg, 96, 4, 2), cluster_of(pkg, "ii", 8)))
        assert np.array_equal(out[1].assignment, out[0].assignment)
        assert sorted(P.ALL_BASELINES) == sorted(R.ALL_BASELINES)


class TestBaselineInternals:
    def test_job_graph_and_fm_bipartition(self):
        from repro.core import baselines as rb
        from repro_torch.core import baselines as pb

        for n_gpus, tp, pp in ((96, 4, 2), (256, 8, 8), (512, 4, 4)):
            ref_comm, port_comm = both(lambda pkg: comm_of(pkg, n_gpus, tp, pp))
            adj_r, adj_p = rb._job_graph(ref_comm), pb._job_graph(port_comm)
            assert adj_p == adj_r
            cells = list(adj_r)
            for size_a in (1, len(cells) // 3, len(cells) // 2):
                assert pb._fm_bipartition(adj_p, cells, size_a) == \
                    rb._fm_bipartition(adj_r, cells, size_a)
