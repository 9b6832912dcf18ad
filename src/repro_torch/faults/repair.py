"""The elastic repair escalation ladder (DESIGN.md §11.2).

``FailureManager`` (paper Appendix B) implemented only the first rung:
promote a reserved backup node.  This module promotes that sketch into a
full :class:`ElasticRepairPolicy` registered behind the ``Scheduler``
contract, with an explicit escalation ladder -- each tier tried only when
the previous is exhausted, each carrying a *modeled* cost so the simulator
can account goodput:

====== ========================== =====================================
tier   action                     dominant cost
====== ========================== =====================================
backup promote same-domain backup rollback to last checkpoint
domain same-domain free node      rollback + state migration
warm   nearest cross-domain node  rollback + migration + warm re-solve
shrink drop one DP replica row    rollback + DP-group reconfiguration
restart checkpoint-restart        rollback + cold solve + full reload
====== ========================== =====================================

Every tier may trigger a **preemption cascade**: a ``claimer`` callback
(provided by the simulator's fault driver) evicts preemptable queue jobs
to free nodes -- in the failed node's domain first, anywhere for the
later tiers (arXiv:2411.11560).  Candidate ordering is fabric-aware
throughout: same locality domain, then domains the affected groups
already span, then nearest by ``Cluster.domain_distance`` -- on ``clos``
hop distance is uniform, so the order reduces to the legacy
``FailureManager`` one (parity kept for its tests).

All costs are *modeled* from fixed knobs (:class:`RepairCosts`) and the
calibrated network model -- never measured wall-clock -- so a same-seed
replay is bit-identical (the benchmark asserts the parity checksum).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.comm_matrix import build_comm_matrix
from repro_torch.core.mip import Infeasible
from repro_torch.core.netmodel import fabric_net_model
from repro_torch.core.spread import Placement, max_spreads
from repro_torch.core.topology import GPUS_PER_NODE, Cluster

#: ladder tiers, least to most disruptive.
TIERS = ("backup", "domain", "warm", "shrink", "restart")
_SEVERITY = {t: i for i, t in enumerate(TIERS)}

#: claimer(n_nodes, domain) -> freed node ids (already released); the
#: preemption-cascade hook the fault driver provides.
Claimer = Callable[[int, Optional[int]], list[int]]


@dataclasses.dataclass(frozen=True)
class RepairCosts:
    """Deterministic cost knobs for the ladder's goodput accounting.

    ``state_bytes_per_node`` defaults to ~160 GB: a 7B-scale stage's
    parameters plus two fp32 optimizer moments across the node's 8 GPUs.
    ``ckpt_read_bw`` is per-node blob-store reload bandwidth (contended,
    hence far below the NIC line rate); migration of live state between
    healthy nodes instead runs at the net model's p2p BusBw.
    """

    ckpt_interval_s: float = 900.0      # expected rollback = interval / 2
    detect_s: float = 30.0              # failure detection + quorum
    warm_solve_s: float = 1.0           # modeled warm-start repair solve
    cold_solve_s: float = 20.0          # modeled full re-place solve (§8)
    restart_overhead_s: float = 60.0    # job teardown + relaunch
    reconfig_s: float = 30.0            # DP-group rebuild on elastic shrink
    state_bytes_per_node: float = 160e9
    ckpt_read_bw: float = 2e9           # bytes/s per node from the ckpt store

    def lost_work_s(self) -> float:
        return self.ckpt_interval_s / 2.0

    def reload_s(self) -> float:
        return self.state_bytes_per_node / self.ckpt_read_bw


@dataclasses.dataclass(frozen=True)
class RepairOutcome:
    """What one repair batch did and what it cost (modeled seconds)."""

    t: float
    tier: str                      # worst tier used
    failed: tuple[int, ...]
    replacements: tuple[int, ...]
    tiers: tuple[str, ...]         # tier per ladder action taken
    downtime_s: float
    lost_work_s: float
    migration_s: float
    capacity: float                # DP capacity factor after repair (<= 1)
    shrunk_rows: int = 0


def _worst(tiers: Sequence[str]) -> str:
    return max(tiers, key=lambda t: _SEVERITY[t]) if tiers else "none"


class BoundRepair:
    """The ladder bound to one running LPJ: owns its backups, dead set,
    and (possibly shrunk) placement; mutates the cluster like a real
    repair controller would (replacements are allocated, dropped rows
    released, failed nodes stay allocated -- quarantined).
    """

    def __init__(
        self,
        placement: Placement,
        cluster: Cluster,
        *,
        backup_frac: float = 0.05,
        alpha: float = 0.5,
        unit: str = "pp",
        claimer: Optional[Claimer] = None,
        costs: Optional[RepairCosts] = None,
        inner=None,                      # Scheduler for the restart tier
        enable_shrink: bool = True,
        max_tier: str = "restart",
        forced_tier: Optional[str] = None,
    ):
        if max_tier not in TIERS:
            raise ValueError(f"max_tier must be one of {TIERS}")
        self.placement = placement
        self.cluster = cluster
        self.costs = costs or RepairCosts()
        self.net = fabric_net_model(cluster.fabric)
        self.claimer = claimer
        self.inner = inner
        self.alpha, self.unit = alpha, unit
        self.enable_shrink = enable_shrink
        self.max_tier = max_tier
        self.forced_tier = forced_tier
        self.dead: set[int] = set()      # quarantined: allocated, never reused
        self.placed: set[int] = set(placement.node_ids())
        self.outcomes: list[RepairOutcome] = []
        self.capacity = 1.0
        self._rows0 = placement.comm.n_rows  # full-capacity DP replica count
        self.shrunk_rows = 0
        self.grown_rows = 0
        self.backups: dict[int, list[int]] = {}
        self._reserve_backups(backup_frac)

    # ------------------------------------------------------------- backups
    def _reserve_backups(self, backup_frac: float) -> None:
        """Reserve ceil(backup_frac * usage) free nodes in every locality
        domain the job occupies (Appendix B, generalized from minipods to
        fabric domains)."""
        if backup_frac <= 0:
            return
        domains_used: dict[int, int] = {}
        for nid in self.placement.node_ids():
            d = self.cluster.domain_of(nid)
            domains_used[d] = domains_used.get(d, 0) + 1
        for d, used in domains_used.items():
            want = max(1, int(np.ceil(backup_frac * used)))
            free = self.cluster.free_in_domain(d)[:want]
            if free:
                self.cluster.allocate(free)
                self.backups[d] = list(free)

    def backup_count(self) -> int:
        return sum(len(v) for v in self.backups.values())

    def _replenish(self, domain: int) -> None:
        """Refill a consumed backup slot from the domain's free pool so the
        cheap tier stays available under sustained churn (Appendix B's pool
        is maintained, not one-shot)."""
        repl = self._free_in(domain)
        if repl is not None:
            self.cluster.allocate([repl])
            self.backups.setdefault(domain, []).append(repl)

    def kill_backup(self, node: int) -> bool:
        """Drop a failed backup from the pool (stays allocated -- the
        driver quarantines it).  Returns whether it was a backup."""
        for d, lst in self.backups.items():
            if node in lst:
                lst.remove(node)
                self.dead.add(node)
                return True
        return False

    # ----------------------------------------------------------- node tiers
    def _swap(self, node: int, repl: int) -> None:
        a = self.placement.assignment
        r, c = np.argwhere(a == node)[0]
        a[r, c] = repl
        self.placed.discard(node)
        self.placed.add(repl)

    def _free_in(self, domain: int) -> Optional[int]:
        for n in self.cluster.free_in_domain(domain):
            if n not in self.dead:
                return int(n)
        return None

    def _repair_node(self, node: int) -> Optional[tuple[str, int]]:
        """Tiers backup/domain/warm for one failed placed node; None when
        no free node exists anywhere (caller escalates)."""
        pod = self.cluster.domain_of(node)
        # (1) promoted same-domain backup: spread unchanged, no solve.
        if self.backups.get(pod):
            repl = self.backups[pod].pop(0)
            self._swap(node, repl)
            self._replenish(pod)
            return "backup", repl
        # (2) same-domain free node; a cascade may create one.
        repl = self._free_in(pod)
        if repl is None and self.claimer is not None:
            self.claimer(1, pod)
            repl = self._free_in(pod)
        if repl is not None:
            self.cluster.allocate([repl])
            self._swap(node, repl)
            return "domain", repl
        if _SEVERITY[self.max_tier] < _SEVERITY["warm"]:
            return None
        # (3) warm cross-domain: domains the affected groups already span
        # first, then nearest by fabric hop distance (uniform on clos, so
        # the legacy FailureManager order is preserved there).
        a = self.placement.assignment
        r, c = np.argwhere(a == node)[0]
        group_pods = {
            self.cluster.domain_of(int(n))
            for n in np.concatenate([a[r, :], a[:, c]])
            if int(n) != node
        }
        candidates = sorted(
            (p for p in range(self.cluster.n_domains) if p != pod),
            key=lambda p: (
                p not in group_pods,
                self.cluster.domain_distance(pod, p),
                p,
            ),
        )
        repl = next(
            (f for p in candidates if (f := self._free_in(p)) is not None), None
        )
        if repl is None and self.claimer is not None:
            self.claimer(1, None)
            repl = next(
                (f for p in candidates if (f := self._free_in(p)) is not None),
                None,
            )
        if repl is not None:
            self.cluster.allocate([repl])
            self._swap(node, repl)
            return "warm", repl
        return None

    # ------------------------------------------------------ escalation tiers
    def _shrink_row(self, node: int) -> list[int]:
        """Elastic shrink: drop the DP-replica row containing ``node``,
        release its healthy nodes, rebuild the comm matrix one replica
        smaller.  Training continues at reduced capacity."""
        a = self.placement.assignment
        r = int(np.argwhere(a == node)[0][0])
        row_nodes = [int(x) for x in a[r]]
        new_a = np.delete(a, r, axis=0)
        job = self.placement.comm.job
        new_job = dataclasses.replace(
            job, n_gpus=job.n_gpus - GPUS_PER_NODE * a.shape[1]
        )
        healthy = [n for n in row_nodes if n not in self.dead]
        self.cluster.release(healthy)
        self.placement = Placement(
            comm=build_comm_matrix(new_job), assignment=new_a,
            cluster=self.cluster,
        )
        self.capacity = new_a.shape[0] / self._rows0
        self.shrunk_rows += 1
        self.placed = set(self.placement.node_ids())
        return row_nodes

    def can_grow(self) -> bool:
        return self.placement.comm.n_rows < self._rows0

    def grow(self, now: float) -> Optional[RepairOutcome]:
        """Elastic re-grow: when capacity returned to the pool after a
        shrink, add a DP replica row back (the grow half of shrink/grow).
        The new replica clones state from a live peer -- a brief DP-group
        reconfiguration plus one migration, no rollback.  Fabric-aware
        node choice: domains the job already occupies first, then nearest
        by hop distance to the most-used domain."""
        if not self.can_grow():
            return None
        n_cols = self.placement.comm.n_cols
        used: dict[int, int] = {}
        for nid in self.placed:
            d = self.cluster.domain_of(nid)
            used[d] = used.get(d, 0) + 1
        anchor = max(used, key=lambda d: (used[d], -d))
        order = sorted(
            range(self.cluster.n_domains),
            key=lambda p: (
                p not in used,
                self.cluster.domain_distance(anchor, p),
                p,
            ),
        )
        picked: list[int] = []
        for p in order:
            for n in self.cluster.free_in_domain(p):
                if n not in self.dead:
                    picked.append(int(n))
                    if len(picked) == n_cols:
                        break
            if len(picked) == n_cols:
                break
        if len(picked) < n_cols:
            return None
        self.cluster.allocate(picked)
        a = self.placement.assignment
        new_a = np.vstack([a, np.array(picked, dtype=a.dtype)])
        job = self.placement.comm.job
        new_job = dataclasses.replace(
            job, n_gpus=job.n_gpus + GPUS_PER_NODE * n_cols
        )
        self.placement = Placement(
            comm=build_comm_matrix(new_job), assignment=new_a,
            cluster=self.cluster,
        )
        self.capacity = new_a.shape[0] / self._rows0
        self.grown_rows += 1
        self.placed = set(self.placement.node_ids())
        c = self.costs
        outcome = RepairOutcome(
            t=now,
            tier="grow",
            failed=(),
            replacements=tuple(picked),
            tiers=("grow",),
            downtime_s=c.reconfig_s + self._migration_s(),
            lost_work_s=0.0,
            migration_s=self._migration_s(),
            capacity=self.capacity,
            shrunk_rows=self.shrunk_rows,
        )
        self.outcomes.append(outcome)
        return outcome

    def _restart(self) -> None:
        """Checkpoint-restart: release every healthy placed node and all
        backups, re-place the (current, possibly shrunk) comm matrix from
        scratch via the inner scheduler.  Dead nodes stay allocated, so
        they are excluded from the solve automatically."""
        if self.inner is None:
            raise Infeasible("restart tier needs an inner scheduler")
        from repro_torch.core.scheduler import ScheduleRequest

        healthy = sorted(n for n in self.placed if n not in self.dead)
        self.cluster.release(healthy)
        for lst in self.backups.values():
            self.cluster.release(lst)
        self.backups = {}
        request = ScheduleRequest(
            comm=self.placement.comm, cluster=self.cluster,
            alpha=self.alpha, unit=self.unit,
        )
        try:
            result = self.inner.schedule(request)
        except Infeasible:
            if self.claimer is None or not self.claimer(
                self.placement.comm.n_cells, None
            ):
                self.cluster.allocate(healthy)  # restore; caller handles
                raise
            result = self.inner.schedule(request)
        self.placement = result.placement
        self.cluster.allocate(self.placement.node_ids())
        self.placed = set(self.placement.node_ids())

    def repair_one(self, node: int) -> Optional[tuple[str, int]]:
        """Quarantine ``node`` and run the node tiers (backup/domain/warm)
        only -- the :class:`FailureManager` compatibility entry point.
        Returns ``(tier, replacement)`` or None when those tiers are
        exhausted (no free node anywhere)."""
        if node not in self.placed:
            raise ValueError(f"node {node} not part of the placement")
        self.dead.add(node)
        return self._repair_node(node)

    # --------------------------------------------------------------- repair
    def repair(self, failed: Sequence[int], now: float) -> RepairOutcome:
        """Run the ladder for a batch of simultaneously failed placed
        nodes (a correlated blast repairs as one event: one rollback, one
        downtime window).  Raises :class:`Infeasible` when the allowed
        tiers cannot restore a full placement."""
        pending = [n for n in failed if n in self.placed]
        for n in pending:
            self.dead.add(n)
        tiers: list[str] = []
        replacements: list[int] = []
        while pending:
            node = pending.pop(0)
            if node not in self.placed:
                continue  # covered by an earlier shrink/restart
            got = None
            if self.forced_tier is None:
                got = self._repair_node(node)
            if got is not None:
                tiers.append(got[0])
                replacements.append(got[1])
                continue
            # Escalate: shrink if allowed and possible, else restart.
            can_shrink = (
                self.forced_tier is None
                and self.enable_shrink
                and _SEVERITY[self.max_tier] >= _SEVERITY["shrink"]
                and self.placement.comm.n_rows > 1
            )
            if can_shrink:
                dropped = self._shrink_row(node)
                tiers.append("shrink")
                pending = [n for n in pending if n not in dropped]
                continue
            if _SEVERITY[self.max_tier] >= _SEVERITY["restart"]:
                self._restart()
                tiers.append("restart")
                pending = []
                continue
            raise Infeasible("no free node anywhere to repair the placement")
        outcome = self._outcome(now, tuple(failed), tiers, replacements,
                                lost_work=True)
        self.outcomes.append(outcome)
        return outcome

    def on_straggler(self, node: int, now: float,
                     escalate: bool = True) -> Optional[RepairOutcome]:
        """Migrate a persistently slow node out of the placement (state
        moves live: no rollback).  A same-domain backup is cheapest; with
        ``escalate`` the node tiers run too -- a sustained straggler costs
        far more effective time than one live migration -- searched while
        the straggler is still allocated, so it cannot replace itself.
        Never shrinks or restarts over a mere slowdown.  Returns None
        when the node must be tolerated (``escalate=False`` keeps the
        legacy ``FailureManager`` backup-only semantics)."""
        pod = self.cluster.domain_of(node)
        if self.backups.get(pod):
            repl = self.backups[pod].pop(0)
            self._swap(node, repl)
            self._replenish(pod)  # before releasing: a slow node must not
            self.cluster.release([node])  # become the fresh hot-spare
            outcome = self._outcome(now, (node,), ["backup"], [repl],
                                    lost_work=False)
            self.outcomes.append(outcome)
            return outcome
        if not escalate or self.forced_tier is not None:
            return None
        got = self._repair_node(node)
        if got is None:
            return None
        self.cluster.release([node])  # healthy and now out of the placement
        outcome = self._outcome(now, (node,), [got[0]], [got[1]],
                                lost_work=False)
        self.outcomes.append(outcome)
        return outcome

    # ---------------------------------------------------------------- costs
    def _migration_s(self) -> float:
        size = self.costs.state_bytes_per_node
        return size / self.net.p2p_busbw(size, spread=1)

    def _outcome(self, now, failed, tiers, replacements, *, lost_work
                 ) -> RepairOutcome:
        c = self.costs
        mig = self._migration_s() if replacements else 0.0
        downtime = c.detect_s + mig  # replacements reload in parallel
        if "warm" in tiers:
            downtime += c.warm_solve_s
        if "shrink" in tiers:
            downtime += c.reconfig_s
        if "restart" in tiers:
            downtime += c.restart_overhead_s + c.cold_solve_s + c.reload_s()
        return RepairOutcome(
            t=now,
            tier=_worst(tiers),
            failed=tuple(int(n) for n in failed),
            replacements=tuple(int(n) for n in replacements),
            tiers=tuple(tiers),
            downtime_s=downtime,
            lost_work_s=c.lost_work_s() if lost_work and tiers else 0.0,
            migration_s=mig,
            capacity=self.capacity,
            shrunk_rows=self.shrunk_rows,
        )


class _NeverBound:
    """The never-repair baseline's bound state: failed nodes stay dead in
    the placement; ``repair`` reports that nothing was done (the driver
    halts training until every dead placed node returns to service)."""

    def __init__(self, placement: Placement, cluster: Cluster):
        self.placement = placement
        self.cluster = cluster
        self.dead: set[int] = set()
        self.placed: set[int] = set(placement.node_ids())
        self.backups: dict[int, list[int]] = {}
        self.outcomes: list[RepairOutcome] = []
        self.capacity = 1.0
        self.shrunk_rows = 0

    def backup_count(self) -> int:
        return 0

    def kill_backup(self, node: int) -> bool:
        return False

    def repair(self, failed: Sequence[int], now: float) -> None:
        for n in failed:
            if n in self.placed:
                self.dead.add(n)
        return None

    def on_straggler(self, node: int, now: float,
                     escalate: bool = True) -> None:
        return None


# ---------------------------------------------------------------------------
# Policies (Scheduler-contract front ends).
# ---------------------------------------------------------------------------

class ElasticRepairPolicy:
    """The escalation ladder behind the unified ``Scheduler`` contract.

    As a registered scheduler (``get_scheduler("elastic")``) it serves two
    shapes of request: a warm request (``prev_placement`` + ``dirty_nodes``
    intersecting the placement) runs the ladder *statelessly* -- no
    backups, no allocation, possibly returning a shrunk placement, with
    the tier and modeled costs in ``stats["repair"]``; any other request
    delegates to the inner chain (default ``"hier,mip,topo-aware"``).

    The simulator's fault driver instead uses :meth:`bind` to get a
    stateful :class:`BoundRepair` (backups reserved, cluster mutated,
    preemption cascades via ``claimer``) for a running LPJ.
    """

    name = "elastic"

    def __init__(
        self,
        inner: str = "hier,mip,topo-aware",
        backup_frac: float = 0.05,
        costs: Optional[RepairCosts] = None,
        enable_shrink: bool = True,
    ):
        self.inner_spec = inner
        self.backup_frac = backup_frac
        self.costs = costs or RepairCosts()
        self.enable_shrink = enable_shrink

    def _inner(self):
        from repro_torch.core.scheduler import get_scheduler

        return get_scheduler(self.inner_spec)

    def bind(self, placement: Placement, cluster: Cluster, *,
             alpha: float = 0.5, unit: str = "pp",
             claimer: Optional[Claimer] = None,
             costs: Optional[RepairCosts] = None,
             backup_frac: Optional[float] = None,
             **kw) -> BoundRepair:
        return BoundRepair(
            placement, cluster,
            backup_frac=self.backup_frac if backup_frac is None else backup_frac,
            alpha=alpha, unit=unit, claimer=claimer,
            costs=costs or self.costs, inner=self._inner(),
            enable_shrink=self.enable_shrink, **kw,
        )

    # ------------------------------------------------------------- contract
    def schedule(self, request):
        prev = request.prev_placement
        if prev is not None and (
            set(request.dirty_nodes) & set(prev.node_ids())
        ):
            return self._schedule_repair(request)
        return self._inner().schedule(request)

    def _schedule_repair(self, request):
        """Stateless ladder over a warm request: repairs ``prev_placement``
        around the dirty nodes without touching the cluster's free set
        (the caller allocates, per the contract)."""
        from repro_torch.core.scheduler import ScheduleResult

        prev = request.prev_placement
        dirty = set(request.dirty_nodes)
        assignment = prev.assignment.copy()
        comm = request.comm
        tiers: list[str] = []
        replacements: list[int] = []
        taken: set[int] = set()
        enable_shrink = bool(
            request.options.get("enable_shrink", self.enable_shrink)
        )
        with request.masked_cluster() as cluster:
            unusable = dirty | set(prev.node_ids())
            pending = sorted(dirty & set(int(n) for n in assignment.ravel()))
            while pending:
                node = pending.pop(0)
                if node not in assignment:
                    continue  # dropped with an earlier shrink
                repl = self._find_free(cluster, assignment, node,
                                       unusable | taken)
                if repl is not None:
                    r, c = np.argwhere(assignment == node)[0]
                    same = cluster.domain_of(repl) == cluster.domain_of(node)
                    assignment[r, c] = repl
                    taken.add(repl)
                    tiers.append("domain" if same else "warm")
                    replacements.append(repl)
                    continue
                if enable_shrink and assignment.shape[0] > 1:
                    r = int(np.argwhere(assignment == node)[0][0])
                    assignment = np.delete(assignment, r, axis=0)
                    job = comm.job
                    comm = build_comm_matrix(dataclasses.replace(
                        job, n_gpus=job.n_gpus - GPUS_PER_NODE * prev.comm.n_cols
                    ))
                    tiers.append("shrink")
                    continue
                # Last rung: cold re-place of whatever shape remains.
                result = self._inner().schedule(dataclasses.replace(
                    request, comm=comm, prev_placement=None,
                    dirty_nodes=frozenset(),
                ))
                result.stats = dict(
                    result.stats,
                    repair=self._repair_stats(tiers + ["restart"], replacements),
                )
                return result
            placement = Placement(comm=comm, assignment=assignment,
                                  cluster=cluster)
        dp_s, pp_s = max_spreads(placement)
        alpha, beta = request.alpha, request.resolved_beta()
        return ScheduleResult(
            placement=placement,
            objective=alpha * dp_s + beta * pp_s,
            dp_spread=dp_s,
            pp_spread=pp_s,
            solve_seconds=0.0,
            method=f"elastic-{_worst(tiers)}",
            stats={"repair": self._repair_stats(tiers, replacements)},
        )

    @staticmethod
    def _find_free(cluster, assignment, node, unusable) -> Optional[int]:
        pod = cluster.domain_of(node)

        def usable(p: int) -> Optional[int]:
            return next(
                (int(n) for n in cluster.free_in_domain(p)
                 if n not in unusable), None,
            )

        local = usable(pod)
        if local is not None:
            return local
        r, c = np.argwhere(assignment == node)[0]
        group_pods = {
            cluster.domain_of(int(n))
            for n in np.concatenate([assignment[r, :], assignment[:, c]])
            if int(n) != node
        }
        candidates = sorted(
            (p for p in range(cluster.n_domains) if p != pod),
            key=lambda p: (
                p not in group_pods,
                cluster.domain_distance(pod, p),
                p,
            ),
        )
        return next(
            (f for p in candidates if (f := usable(p)) is not None), None
        )

    def _repair_stats(self, tiers: list[str], replacements: list[int]) -> dict:
        c = self.costs
        shrunk = tiers.count("shrink")
        downtime = c.detect_s
        if "warm" in tiers:
            downtime += c.warm_solve_s
        if shrunk:
            downtime += c.reconfig_s
        if "restart" in tiers:
            downtime += c.restart_overhead_s + c.cold_solve_s + c.reload_s()
        return {
            "tier": _worst(tiers),
            "tiers": list(tiers),
            "replacements": list(replacements),
            "shrunk_rows": shrunk,
            "downtime_s": downtime,
            "lost_work_s": c.lost_work_s(),
        }


class FullResolveRepair:
    """Baseline: every fault is handled by a full checkpoint-restart
    re-place (the expensive strategy the paper's Limitations section
    rejects).  Same bind interface as the elastic ladder."""

    name = "full-resolve"

    def __init__(self, inner: str = "hier,mip,topo-aware",
                 costs: Optional[RepairCosts] = None):
        self.inner_spec = inner
        self.costs = costs or RepairCosts()

    def bind(self, placement: Placement, cluster: Cluster, *,
             alpha: float = 0.5, unit: str = "pp",
             claimer: Optional[Claimer] = None,
             costs: Optional[RepairCosts] = None, **kw) -> BoundRepair:
        from repro_torch.core.scheduler import get_scheduler

        return BoundRepair(
            placement, cluster, backup_frac=0.0, alpha=alpha, unit=unit,
            claimer=claimer, costs=costs or self.costs,
            inner=get_scheduler(self.inner_spec), enable_shrink=False,
            forced_tier="restart", **kw,
        )

    def schedule(self, request):
        from repro_torch.core.scheduler import get_scheduler

        return get_scheduler(self.inner_spec).schedule(
            dataclasses.replace(request, prev_placement=None,
                                dirty_nodes=frozenset())
        )


class NeverRepair:
    """Baseline: faults are never repaired -- training halts until every
    dead placed node returns to service (permanent faults halt it for
    good).  What a cluster without a repair controller looks like."""

    name = "never"

    def bind(self, placement: Placement, cluster: Cluster, **kw) -> _NeverBound:
        return _NeverBound(placement, cluster)


_REPAIR_POLICIES = {
    "elastic": ElasticRepairPolicy,
    "full": FullResolveRepair,
    "full-resolve": FullResolveRepair,
    "never": NeverRepair,
}


def get_repair_policy(spec):
    """Resolve a repair policy by name ("elastic" | "full" | "never") or
    pass an instance through."""
    if isinstance(spec, str):
        key = spec.strip().lower().replace("_", "-")
        try:
            return _REPAIR_POLICIES[key]()
        except KeyError:
            raise KeyError(
                f"unknown repair policy {spec!r}; "
                f"available: {sorted(_REPAIR_POLICIES)}"
            ) from None
    if hasattr(spec, "bind"):
        return spec
    raise TypeError(f"expected repair policy name or instance, got {type(spec)}")


def _register() -> None:
    from repro_torch.core.scheduler import list_schedulers, register_scheduler

    if "elastic" not in list_schedulers():
        register_scheduler("elastic", ElasticRepairPolicy())


_register()
