"""Hierarchical scale tier: sub-second scheduling at 10k-node scale
(DESIGN.md §8, grounded in the fast-repeatable-placement stage of
arXiv:2411.11560).

The flat MILP in :mod:`repro_torch.core.mip` solves one problem whose variable
count is ``n_groups * n_minipods`` -- fine at the paper's 11-minipod
settings, hopeless under a 1 s budget when the cluster has 100+ minipods.
This tier keeps the paper's Eq. 2 spread objective but decomposes the
solve so cost scales with the *pods a job touches*, not cluster size:

1. **Coarse stage** -- minipods are grouped into contiguous *blocks* of
   ``pods_per_block``; one small MILP (reusing :func:`mip._solve_counts`
   with block-aggregate capacities) decides how many nodes of each
   scheduling-unit group land in each block.
2. **Fine stage** -- per selected block, an *independent* minipod-level
   MILP places the whole groups assigned to that block; seam groups that
   straddle blocks are placed by a best-fit splitter.  Blocks the coarse
   stage did not select are never looked at.
3. **Warm-start re-solve** -- when the request carries ``prev_placement``
   and a small ``dirty_nodes`` set (failure churn, the path the
   reference's ``FailureManager``/``TraceSimulator`` exercise), the previous placement
   is repaired locally (same-pod free node first, then pods the affected
   groups already span) instead of re-solving from scratch.
4. **Placement cache** -- solved counts matrices are memoized in a
   :class:`repro_torch.core.placement_cache.PlacementCache` keyed on (matrix
   shape, unit, weights, quantized free signature), so recurring job
   shapes skip the solve entirely.

When the cluster fits in a single block the tier degenerates to the flat
MILP (identical counts), which is how the paper-setting spread parity is
guaranteed.  Registered as ``"hier"``; composes as
``FallbackChain("hier", "mip", "topo-aware")``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core.mip import (
    Infeasible,
    _counts_objective,
    _counts_to_placement,
    _solve_counts,
)
from repro_torch.core.placement_cache import PlacementCache
from repro_torch.core.spread import Placement, max_spreads
from repro_torch.core.topology import Cluster

# Fraction of the time budget handed to the coarse block-level solve; the
# remainder is split evenly across the active blocks' fine solves.
_COARSE_BUDGET_FRAC = 0.4
_MIN_STAGE_BUDGET = 0.05


class HierarchicalScheduler:
    """Pod-block decomposition + warm-start + placement cache ("hier").

    ``request.options`` knobs:

    * ``pods_per_block`` (default 16) -- minipods per coarse block; paper
      settings (<= 11 minipods) collapse to one block = flat MILP.
    * ``repair_max_dirty`` (default 8) -- warm-start repair is attempted
      only when at most this many placed nodes are dirty; larger churn
      falls through to a cold solve.
    * ``use_cache`` (default True) -- consult/fill the placement cache.
    * ``integral_nodes`` / ``use_greedy_bound`` -- passed to the MILP
      stages (same meaning as for ``"mip"``).
    """

    name = "hier"

    def __init__(self, pods_per_block: int = 16, cache: Optional[PlacementCache] = None):
        self.pods_per_block = pods_per_block
        self.cache = cache if cache is not None else PlacementCache()

    # ----------------------------------------------------------------- entry
    def schedule(self, request) -> "ScheduleResult":
        from repro_torch.core.scheduler import ScheduleResult  # cycle-free at call time

        t0 = time.perf_counter()
        warm = self._try_repair(request)
        if warm is not None:
            return warm

        alpha, beta = request.alpha, request.resolved_beta()
        comm = request.comm
        n_groups = comm.n_rows if request.unit == "pp" else comm.n_cols
        group_size = comm.n_cols if request.unit == "pp" else comm.n_rows
        ppb = int(request.options.get("pods_per_block", self.pods_per_block))
        use_cache = bool(request.options.get("use_cache", True))

        with request.masked_cluster() as cluster:
            free = np.array(cluster.free_capacities(), dtype=float)
            blocks = cluster.scheduling_blocks(ppb)
            cache_key = self.cache.key(
                comm, cluster, request.unit, alpha, beta, extra=("ppb", ppb)
            )
            counts = self.cache.lookup(cache_key, free) if use_cache else None
            cached = counts is not None
            stage_stats: dict = {}
            if counts is None:
                counts, stage_stats = self._solve_hierarchical(
                    group_size, n_groups, free, alpha, beta, request, blocks
                )
                if use_cache:
                    self.cache.store(cache_key, counts)
            placement = _counts_to_placement(comm, cluster, counts, request.unit)

        dp_s, pp_s = max_spreads(placement)
        dt = time.perf_counter() - t0
        stats = {
            "counts": counts,
            "n_pods_used": int((counts.sum(axis=0) > 0).sum()),
            "max_unit_spread": int(max((row > 0).sum() for row in counts)),
            "warm_start": False,
            "cache": dict(self.cache.stats.as_dict(), hit=cached),
            **stage_stats,
        }
        return ScheduleResult(
            placement=placement,
            objective=_counts_objective(counts, alpha, beta),
            dp_spread=dp_s,
            pp_spread=pp_s,
            solve_seconds=dt,
            method="hier-cached" if cached else "hier",
            stats=stats,
        )

    # ------------------------------------------------------- hierarchical solve
    def _solve_hierarchical(
        self,
        group_size: int,
        n_groups: int,
        free: np.ndarray,
        alpha: float,
        beta: float,
        request,
        blocks: list[list[int]],
    ) -> tuple[np.ndarray, dict]:
        """Coarse block solve + independent per-block fine solves.

        ``blocks`` is the fabric's locality-coherent domain grouping
        (:meth:`Cluster.scheduling_blocks`) -- contiguous id ranges on
        ``clos`` (identical to the pre-fabric behaviour), torus slabs /
        dragonfly groups elsewhere.  Returns the global
        ``(n_groups, n_domains)`` counts and per-stage stats.  A
        single-block cluster short-circuits to the flat MILP.
        """
        k = len(free)
        integral = request.options.get("integral_nodes", True)
        greedy = request.options.get("use_greedy_bound", True)
        budget = request.time_budget

        if len(blocks) == 1:
            counts, _, _, method = _solve_counts(
                group_size, n_groups, free, alpha, beta, integral, budget,
                use_greedy_bound=greedy,
            )
            return counts, {"n_blocks": 1, "blocks_touched": 1,
                            "coarse_method": "flat", "fine_methods": [method]}

        t0 = time.perf_counter()
        block_free = np.array([free[blk].sum() for blk in blocks], dtype=float)
        coarse_budget = max(_MIN_STAGE_BUDGET, budget * _COARSE_BUDGET_FRAC)
        coarse, _, _, coarse_method = _solve_counts(
            group_size, n_groups, block_free, alpha, beta, True, coarse_budget,
            use_greedy_bound=greedy,
        )

        counts = np.zeros((n_groups, k), dtype=int)
        active = [b for b in range(len(blocks)) if coarse[:, b].sum() > 0]
        fine_methods: list[str] = []
        for bi, b in enumerate(active):
            blk = blocks[b]
            demands = coarse[:, b]
            work = free[blk].astype(float).copy()
            whole = [g for g in range(n_groups) if demands[g] == group_size]
            partial = [g for g in range(n_groups) if 0 < demands[g] < group_size]
            # Seam groups first: they have hard per-block demands, and
            # placing them up front keeps the whole-group MILP feasible
            # (total block capacity >= total block demand by construction).
            for g in sorted(partial, key=lambda g: -demands[g]):
                self._place_partial(counts, g, int(demands[g]), blk, work)
            if whole:
                remaining = budget - (time.perf_counter() - t0)
                fine_budget = max(
                    _MIN_STAGE_BUDGET, remaining / max(1, len(active) - bi)
                )
                sub, _, _, method = _solve_counts(
                    group_size, len(whole), work, alpha, beta, integral,
                    fine_budget, use_greedy_bound=greedy,
                )
                fine_methods.append(method)
                for gi, g in enumerate(whole):
                    for ji, j in enumerate(blk):
                        counts[g, j] += int(sub[gi, ji])
        return counts, {
            "n_blocks": len(blocks),
            "blocks_touched": len(active),
            "coarse_method": coarse_method,
            "fine_methods": fine_methods,
        }

    @staticmethod
    def _place_partial(
        counts: np.ndarray, g: int, need: int, blk: list[int], work: np.ndarray
    ) -> None:
        """Place ``need`` nodes of seam group ``g`` into the block: whole
        into the tightest sufficient minipod (best-fit, preserves large
        pods for whole groups), else split largest-first."""
        fit = [i for i in range(len(blk)) if work[i] >= need]
        if fit:
            i = min(fit, key=lambda i: (work[i], i))
            counts[g, blk[i]] += need
            work[i] -= need
            return
        for i in np.argsort(-work):
            if need == 0:
                return
            take = int(min(work[i], need))
            if take <= 0:
                continue
            counts[g, blk[i]] += take
            work[i] -= take
            need -= take
        if need:
            raise Infeasible(
                f"block {blk[0]}-{blk[-1]} lacks capacity for seam group {g}"
            )

    # ------------------------------------------------------------ warm start
    def _try_repair(self, request) -> "ScheduleResult | None":
        """Local repair of ``prev_placement`` around ``dirty_nodes``.

        Returns a result (method ``"hier-warm"``) or None to fall through
        to the cold path.  Replacement preference mirrors
        the reference's ``FailureManager``: same domain (spread unchanged), then a
        domain the affected groups already span (nearest by fabric hop
        distance first), then any free node.
        """
        from repro_torch.core.scheduler import ScheduleResult

        prev = request.prev_placement
        if prev is None or prev.comm.shape != request.comm.shape:
            return None
        dirty = set(request.dirty_nodes)
        max_dirty = int(request.options.get("repair_max_dirty", 8))
        placed = set(prev.node_ids())
        affected = sorted(dirty & placed)
        if len(affected) > max_dirty:
            return None

        t0 = time.perf_counter()
        assignment = prev.assignment.copy()
        repaired: list[tuple[int, int]] = []
        taken: set[int] = set()
        with request.masked_cluster() as cluster:
            for node in affected:
                repl = self._find_replacement(
                    cluster, assignment, node, dirty | placed | taken
                )
                if repl is None:
                    return None  # cold solve handles it
                r, c = np.argwhere(assignment == node)[0]
                assignment[r, c] = repl
                taken.add(repl)
                repaired.append((int(node), int(repl)))
            placement = Placement(
                comm=request.comm, assignment=assignment, cluster=cluster
            )
        dp_s, pp_s = max_spreads(placement)
        alpha, beta = request.alpha, request.resolved_beta()
        return ScheduleResult(
            placement=placement,
            objective=alpha * dp_s + beta * pp_s,
            dp_spread=dp_s,
            pp_spread=pp_s,
            solve_seconds=time.perf_counter() - t0,
            method="hier-warm",
            stats={
                "warm_start": True,
                "repaired": repaired,
                "cache": dict(self.cache.stats.as_dict(), hit=False),
            },
        )

    @staticmethod
    def _find_replacement(
        cluster: Cluster,
        assignment: np.ndarray,
        node: int,
        unusable: set[int],
    ) -> Optional[int]:
        pod = cluster.domain_of(node)

        def usable(p: int) -> list[int]:
            return [n for n in cluster.free_in_domain(p) if n not in unusable]

        local = usable(pod)
        if local:
            return local[0]
        r, c = np.argwhere(assignment == node)[0]
        group_pods = {
            cluster.domain_of(int(n))
            for n in np.concatenate([assignment[r, :], assignment[:, c]])
            if int(n) != node
        }
        # Prefer domains the groups already span, then nearest by fabric
        # hop distance (uniform on clos, so the order there is unchanged).
        candidates = sorted(
            (p for p in range(cluster.n_domains) if p != pod),
            key=lambda p: (p not in group_pods, cluster.domain_distance(pod, p), p),
        )
        for p in candidates:
            avail = usable(p)
            if avail:
                return avail[0]
        return None
