"""Resource management: queue policy with LPJ reservation (paper §5.3,
Algorithm 1, Appendices G/H).

Once an LPJ is *planned* (its arrival time announced), the scheduler solves
the placement MIP immediately and **reserves** the chosen nodes.  From then
on incoming jobs are:

* scheduled normally if they fit outside the reserved zone,
* opportunistically back-filled *into* the reserved zone iff their predicted
  JCT (GBM, Appendix G) completes before the LPJ arrives,
* scheduled anyway if preemptable (evicted on LPJ arrival),
* otherwise delayed to the next scheduling interval.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.comm_matrix import CommMatrix
from repro_torch.core.jct import JCTPredictor
from repro_torch.core.scheduler import (
    ScheduleRequest,
    ScheduleResult,
    Scheduler,
    get_scheduler,
)
from repro_torch.core.topology import Cluster


@dataclasses.dataclass
class Job:
    """A generic (non-LPJ) cluster job."""

    job_id: int
    n_nodes: int
    arrival: float
    duration: float          # true duration (simulator ground truth)
    metadata: dict = dataclasses.field(default_factory=dict)
    priority: int = 0
    preemptable: bool = False
    # runtime state
    start: Optional[float] = None
    nodes: list[int] = dataclasses.field(default_factory=list)
    in_reserved_zone: bool = False

    def sort_key(self) -> tuple:
        return (-self.priority, self.arrival, self.job_id)


@dataclasses.dataclass
class PlannedLPJ:
    comm: CommMatrix
    arrival: float
    alpha: float
    beta: float
    unit: str = "pp"
    result: Optional[ScheduleResult] = None

    @property
    def reserved_nodes(self) -> set[int]:
        if self.result is None:
            return set()
        return set(self.result.placement.node_ids())


class QueuePolicy:
    """Algorithm 1: reservation-aware queue management."""

    def __init__(
        self,
        cluster: Cluster,
        jct_predictor: Optional[JCTPredictor] = None,
        interval: float = 60.0,
        reserve: bool = True,
        use_jct: bool = True,
        scheduler: "str | Scheduler" = "mip",
    ):
        self.cluster = cluster
        self.jct = jct_predictor
        self.interval = interval
        self.reserve = reserve
        self.use_jct = use_jct
        self.scheduler = get_scheduler(scheduler)
        self.lpj: Optional[PlannedLPJ] = None
        #: pending jobs as (sort_key, job), kept sorted by sort_key (keys are
        #: unique -- sort_key ends in job_id -- so jobs are never compared).
        self.queue: list[tuple[tuple, Job]] = []
        self.running: dict[int, Job] = {}
        # Nodes busy under a *non-preemptable* job, maintained incrementally
        # so retention_rate() is a vectorized mask intersection per tick
        # instead of a scan over every running job's node list.
        self._nonpre_busy = np.zeros(cluster.n_nodes, dtype=bool)
        self._planned_mask_cache: tuple[object, np.ndarray] | None = None

    # ------------------------------------------------------------------ LPJ
    def plan_lpj(self, comm: CommMatrix, arrival: float, alpha: float,
                 beta: float | None = None, unit: str = "pp",
                 scheduler: "str | Scheduler | None" = None) -> ScheduleResult:
        """Solve the placement now and reserve the nodes for the imminent LPJ.

        The policy's scheduler (or the per-call ``scheduler`` override --
        a registry name, instance, or fallback chain) runs against the
        cluster as if empty-of-preemptables: reservation semantics are
        strong (unlike the best-effort reserving-and-packing baseline,
        Appendix H)."""
        beta = 1.0 - alpha if beta is None else beta
        sched = self.scheduler if scheduler is None else get_scheduler(scheduler)
        snapshot = self.cluster.snapshot_free()
        occupied_by_jobs = [
            n for j in self.running.values() for n in j.nodes
        ]
        # Plan over free + currently-running-but-finite capacity: the paper
        # plans hours ahead, so occupied nodes will have drained by arrival.
        self.cluster.release(occupied_by_jobs)
        try:
            result = sched.schedule(ScheduleRequest(
                comm=comm, cluster=self.cluster, alpha=alpha, beta=beta,
                unit=unit,
            ))
        finally:
            self.cluster.allocate(occupied_by_jobs)
            assert self.cluster.snapshot_free() == snapshot
        self.lpj = PlannedLPJ(
            comm=comm, arrival=arrival, alpha=alpha, beta=beta, unit=unit,
            result=result,
        )
        return result

    def replan_lpj(self, dirty_nodes, scheduler: "str | Scheduler | None" = None
                   ) -> ScheduleResult:
        """Re-solve the planned LPJ placement after node churn.

        ``dirty_nodes`` are the nodes that changed (failed/drained) since
        :meth:`plan_lpj`; they are excluded from the new solve and passed
        as the warm-start hint together with the previous placement, so a
        warm-start-capable scheduler ("hier") repairs the reservation
        locally instead of re-solving from scratch.  Updates the stored
        plan (and thereby the reserved zone) in place.
        """
        if self.lpj is None or self.lpj.result is None:
            raise ValueError("no planned LPJ to re-plan")
        lpj = self.lpj
        dirty = frozenset(dirty_nodes)
        sched = self.scheduler if scheduler is None else get_scheduler(scheduler)
        snapshot = self.cluster.snapshot_free()
        occupied_by_jobs = [n for j in self.running.values() for n in j.nodes]
        self.cluster.release(occupied_by_jobs)
        try:
            result = sched.schedule(ScheduleRequest(
                comm=lpj.comm, cluster=self.cluster, alpha=lpj.alpha,
                beta=lpj.beta, unit=lpj.unit, excluded_nodes=dirty,
                prev_placement=lpj.result.placement, dirty_nodes=dirty,
            ))
        finally:
            self.cluster.allocate(occupied_by_jobs)
            assert self.cluster.snapshot_free() == snapshot
        lpj.result = result
        return result

    def reserved_nodes(self) -> set[int]:
        if not self.reserve or self.lpj is None:
            return set()
        return self.lpj.reserved_nodes

    # ---------------------------------------------------------------- queue
    def submit(self, job: Job) -> None:
        bisect.insort(self.queue, (job.sort_key(), job))

    def _mark_started(self, job: Job, nodes: list[int], now: float,
                      in_reserved_zone: bool) -> None:
        self.cluster.allocate(nodes)
        job.nodes, job.start = nodes, now
        job.in_reserved_zone = in_reserved_zone
        self.running[job.job_id] = job
        if not job.preemptable:
            self._nonpre_busy[nodes] = True

    def _predicted_done(self, job: Job, now: float) -> float:
        if self.jct is not None and self.use_jct and job.metadata:
            return now + float(self.jct.predict_seconds([job.metadata])[0])
        return now + job.duration  # oracle fallback

    def schedule_tick(self, now: float) -> list[Job]:
        """One pass of Algorithm 1 over the queue; returns jobs started.

        Batched (DESIGN.md §10): the free pool is extracted from the
        cluster mask **once per tick** and partitioned into
        outside-/inside-reserved-zone id arrays (a mask subtraction, not a
        per-job set comprehension).  Every allocation in Algorithm 1 takes
        a prefix of one of those sorted arrays, so per-job work is a slice
        plus two pointer bumps; a job that cannot start costs O(1) counter
        comparisons.  Selection order is identical to the per-job legacy
        pass (:meth:`schedule_tick_legacy`, parity-tested).
        """
        if not self.queue:
            return []
        started: list[Job] = []
        lpj_pending = self.lpj is not None and now < self.lpj.arrival
        resv_bool = self._planned_mask() if self.reserve else None
        free_ids = self.cluster.free_node_ids()  # sorted
        if resv_bool is not None:
            in_resv = resv_bool[free_ids]
            outside, inside = free_ids[~in_resv], free_ids[in_resv]
        else:
            outside, inside = free_ids, free_ids[:0]
        o = i = 0  # consumed prefixes of outside/inside

        def take_outside(n: int) -> "list[int] | None":
            nonlocal o, i, outside, inside
            # Legacy `_allocate_outside` masks the reserved zone only while
            # the LPJ is pending; afterwards it picks from *all* free nodes
            # in id order.
            if lpj_pending or inside.size == i:
                if outside.size - o < n:
                    return None
                nodes = outside[o:o + n]
                o += n
                return nodes.tolist()
            # Rare: LPJ already admitted but planned nodes back in the free
            # pool -- fall back to an exact merge to preserve id order.
            merged = np.sort(np.concatenate([outside[o:], inside[i:]]))
            if merged.size < n:
                return None
            nodes = merged[:n]
            keep = merged[n:]
            resv_keep = resv_bool[keep]
            outside, inside = keep[~resv_keep], keep[resv_keep]
            o = i = 0
            return nodes.tolist()

        def take_anywhere(n: int, reserved_ok: bool
                          ) -> "tuple[list[int], bool] | None":
            nonlocal o, i
            n_out = min(n, outside.size - o)
            n_in = n - n_out
            if n_in > inside.size - i:
                return None
            if n_in > 0 and not reserved_ok:
                return None
            # Legacy order: non-reserved first (by id), then reserved.
            nodes = outside[o:o + n_out].tolist() + inside[i:i + n_in].tolist()
            o += n_out
            i += n_in
            return nodes, n_in > 0

        for _, job in list(self.queue):
            ok = False
            if job.preemptable:
                got = take_anywhere(job.n_nodes, reserved_ok=True)
                if got is not None:
                    self._mark_started(job, got[0], now, got[1])
                    ok = True
            else:
                nodes = take_outside(job.n_nodes)
                if nodes is not None:
                    self._mark_started(job, nodes, now, False)
                    ok = True
                elif (
                    lpj_pending
                    and self.use_jct
                    and self._predicted_done(job, now) < self.lpj.arrival
                ) or not lpj_pending:
                    got = take_anywhere(job.n_nodes, reserved_ok=True)
                    if got is not None:
                        self._mark_started(job, got[0], now, got[1])
                        ok = True
            if ok:
                started.append(job)
        if started:
            gone = {j.job_id for j in started}
            self.queue = [e for e in self.queue if e[1].job_id not in gone]
        return started

    # ------------------------------------------------ legacy per-job tick
    def _legacy_allocate_outside(self, job: Job, now: float) -> bool:
        reserved = self.reserved_nodes() if (self.lpj and now < self.lpj.arrival) else set()
        free = [n for n in self.cluster.snapshot_free() if n not in reserved]
        if len(free) < job.n_nodes:
            return False
        self._mark_started(job, sorted(free)[: job.n_nodes], now, False)
        return True

    def _legacy_allocate_anywhere(self, job: Job, now: float, reserved_ok: bool) -> bool:
        free = sorted(self.cluster.snapshot_free())
        if len(free) < job.n_nodes:
            return False
        reserved = self.reserved_nodes()
        # Prefer non-reserved nodes even when the zone is allowed.
        free.sort(key=lambda n: (n in reserved, n))
        nodes = free[: job.n_nodes]
        if not reserved_ok and any(n in reserved for n in nodes):
            return False
        self._mark_started(job, nodes, now, any(n in reserved for n in nodes))
        return True

    def schedule_tick_legacy(self, now: float) -> list[Job]:
        """Pre-vectorization Algorithm 1 pass: re-materializes and re-sorts
        the full free set for every queued job.  Kept as the parity /
        speedup reference for :meth:`schedule_tick` (DESIGN.md §10); do not
        use in new code."""
        started: list[Job] = []
        delayed: list[tuple[tuple, Job]] = []
        queue, self.queue = self.queue, []
        for _, job in queue:  # already in sort_key order
            lpj_pending = self.lpj is not None and now < self.lpj.arrival
            if job.preemptable:
                ok = self._legacy_allocate_anywhere(job, now, reserved_ok=True)
            elif self._legacy_allocate_outside(job, now):
                ok = True
            elif (
                lpj_pending
                and self.use_jct
                and self._predicted_done(job, now) < self.lpj.arrival
                and self._legacy_allocate_anywhere(job, now, reserved_ok=True)
            ):
                ok = True
            elif not lpj_pending and self._legacy_allocate_anywhere(
                job, now, reserved_ok=True
            ):
                ok = True
            else:
                ok = False
            if ok:
                started.append(job)
            else:
                delayed.append((job.sort_key(), job))
        self.queue = delayed  # popped in sorted order, so still sorted
        return started

    def complete(self, job_id: int) -> None:
        job = self.running.pop(job_id)
        self.cluster.release(job.nodes)
        if not job.preemptable:
            self._nonpre_busy[job.nodes] = False
        job.nodes = []

    def requeue(self, job_id: int) -> Job:
        """Preempt a running job back into the queue (fault kill or
        preemption cascade, DESIGN.md §11.4): its nodes are released and
        its progress lost -- the job reruns its full duration when next
        scheduled.  Keeps the original sort key, so it competes at its
        submission-time priority."""
        job = self.running.pop(job_id)
        self.cluster.release(job.nodes)
        if not job.preemptable:
            self._nonpre_busy[job.nodes] = False
        job.nodes = []
        job.start = None
        job.in_reserved_zone = False
        self.submit(job)
        return job

    def admit_lpj(self, now: float) -> tuple[list[int], list[Job]]:
        """LPJ arrival: preempt whatever still occupies the reserved zone and
        hand over its nodes.  Returns (lpj nodes, preempted jobs)."""
        assert self.lpj is not None and self.lpj.result is not None
        nodes = self.lpj.result.placement.node_ids()
        node_set = set(nodes)
        preempted = []
        for job in list(self.running.values()):
            if any(n in node_set for n in job.nodes):
                preempted.append(job)
                self.complete(job.job_id)
        self.cluster.allocate(nodes)
        return nodes, preempted

    # -------------------------------------------------------------- metrics
    def allocation_rate(self) -> float:
        """Fraction of cluster nodes running some job (Appendix H)."""
        busy = self.cluster.n_nodes - self.cluster.n_free
        return busy / self.cluster.n_nodes

    def _planned_mask(self) -> Optional[np.ndarray]:
        """Boolean mask of the LPJ's planned nodes, cached per plan result
        (invalidated when replan_lpj swaps the result object)."""
        if self.lpj is None or self.lpj.result is None:
            return None
        cache = self._planned_mask_cache
        if cache is None or cache[0] is not self.lpj.result:
            mask = np.zeros(self.cluster.n_nodes, dtype=bool)
            mask[self.lpj.result.placement.node_ids()] = True
            self._planned_mask_cache = cache = (self.lpj.result, mask)
        return cache[1]

    def retention_rate(self) -> float:
        """Fraction of the LPJ's *planned* nodes occupied by non-preemptable
        jobs -- these would need manual preemption at LPJ arrival (Appendix
        H).  Measured against the plan regardless of whether reservation is
        enforced, so the no-reservation baseline is comparable.  Computed as
        a mask intersection against the incrementally-maintained
        non-preemptable busy mask: O(n_nodes) bit ops, no per-job scan."""
        planned = self._planned_mask()
        if planned is None:
            return 0.0
        n_planned = int(planned.sum())
        if not n_planned:
            return 0.0
        return int(np.count_nonzero(planned & self._nonpre_busy)) / n_planned
