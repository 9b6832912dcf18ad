"""Fault-event orchestration for the trace simulator (DESIGN.md §11.4).

:class:`FaultDriver` owns everything fault-shaped so
:meth:`TraceSimulator.run` stays a clean event loop: it walks the fault
trace, maintains the recovery heap (transient faults return to service,
stragglers end), routes hard faults to the right handler -- the bound
repair ladder for LPJ nodes, a kill-and-requeue for queue jobs, plain
quarantine for free/backup nodes, a reservation replan pre-admit -- and
feeds every repair outcome into the :class:`GoodputTracker`.

The **preemption cascade** lives here too: the driver hands the bound
repair a ``claimer`` that evicts preemptable running queue jobs (same
locality domain first) back into the queue, freeing their nodes for the
repair (arXiv:2411.11560).
"""

from __future__ import annotations

import heapq
from typing import Optional, Sequence

from repro_torch.core.mip import Infeasible
from repro_torch.faults.accounting import GoodputTracker
from repro_torch.faults.model import FaultEvent
from repro_torch.faults.repair import RepairCosts, RepairOutcome, get_repair_policy


class FaultDriver:
    """Binds a fault trace to a running simulation.

    The simulator exposes two extra event streams through the driver:
    :meth:`peek_fault` / :meth:`on_fault` (the pre-generated trace) and
    :meth:`peek_recovery` / :meth:`on_recovery` (returns-to-service and
    straggler endings, discovered as faults are processed).
    """

    def __init__(self, policy, events: Sequence[FaultEvent],
                 repair="elastic", costs: Optional[RepairCosts] = None):
        self.policy = policy
        self.events = list(events)
        self.repair_policy = get_repair_policy(repair)
        self.costs = costs
        self.bound = None
        self.tracker = GoodputTracker()
        self._fi = 0
        self._recoveries: list[tuple[float, int, str, int]] = []
        self._rseq = 0
        self.quarantined: set[int] = set()
        self.failed_nodes: list[int] = []
        self.tier_hist: dict[str, int] = {}
        self.stragglers: dict[int, float] = {}  # active LPJ-node slowdowns
        self.pending_repair = False             # Infeasible ladder: halted
        self.n_faults = 0
        self.n_recoveries = 0
        self.grows = 0
        self.cascades = 0
        self.killed_jobs = 0
        self.straggler_swaps = 0
        self.replans = 0

    # ----------------------------------------------------------- event peeks
    def peek_fault(self) -> Optional[float]:
        return self.events[self._fi].t if self._fi < len(self.events) else None

    def peek_recovery(self) -> Optional[float]:
        return self._recoveries[0][0] if self._recoveries else None

    # ------------------------------------------------------------- lifecycle
    def on_lpj_admitted(self, t: float) -> None:
        lpj = self.policy.lpj
        self.bound = self.repair_policy.bind(
            lpj.result.placement, self.policy.cluster,
            alpha=lpj.alpha, unit=lpj.unit,
            claimer=self._claim, costs=self.costs,
        )
        self.tracker.start(t)

    # ---------------------------------------------------------------- faults
    def on_fault(self, t: float) -> None:
        ev = self.events[self._fi]
        self._fi += 1
        self.n_faults += 1
        if ev.kind == "straggler":
            self._on_straggler(ev, t)
            return
        lpj_failed: list[int] = []
        for node in ev.nodes:
            if node in self.quarantined or (
                self.bound is not None and node in self.bound.dead
            ):
                continue  # already down
            self.failed_nodes.append(node)
            if ev.transient:
                self._push_recovery(t + ev.ttr_s, "return", node)
            if self.bound is not None and node in self.bound.placed:
                lpj_failed.append(node)  # stays allocated; ladder handles it
                continue
            if self.bound is not None and self.bound.kill_backup(node):
                self.quarantined.add(node)  # backups are already allocated
                continue
            if self.policy.cluster.is_free(node):
                self.policy.cluster.allocate([node])
            else:
                job = self._job_on(node)
                if job is not None:
                    self.policy.requeue(job.job_id)
                    self.killed_jobs += 1
                if self.policy.cluster.is_free(node):
                    self.policy.cluster.allocate([node])
            self.quarantined.add(node)
            self._maybe_replan(node, t)
        if lpj_failed:
            self._repair(lpj_failed, t)

    def _job_on(self, node: int):
        for job in self.policy.running.values():
            if node in job.nodes:
                return job
        return None

    def _maybe_replan(self, node: int, t: float) -> None:
        """Pre-admit churn: a fault inside a still-pending LPJ reservation
        re-plans it warm (the ``failures=`` shim's semantics)."""
        lpj = self.policy.lpj
        if (
            lpj is not None and lpj.result is not None
            and t < lpj.arrival
            and node in lpj.reserved_nodes
        ):
            self.policy.replan_lpj(dirty_nodes=frozenset(self.failed_nodes))
            self.replans += 1

    def _repair(self, nodes: list[int], t: float) -> None:
        self.tracker.advance(t)
        try:
            outcome = self.bound.repair(nodes, t)
        except Infeasible:
            self.pending_repair = True  # retried on every return-to-service
            self.tracker.halt(t)
            return
        if outcome is None:  # never-repair: halted until the nodes return
            self.tracker.halt(t)
            return
        self.tier_hist[outcome.tier] = self.tier_hist.get(outcome.tier, 0) + 1
        self.tracker.add_repair(outcome)
        self._sync_slowdown(t)  # a repair may have moved a straggler out

    def _sync_slowdown(self, t: float) -> None:
        """Recompute the LPJ slowdown from stragglers still *in* the
        placement -- one that was migrated away, relocated by a repair, or
        dropped with a shrunk row stops slowing the synchronous step."""
        placed = self.bound.placed if self.bound is not None else ()
        self.tracker.set_slowdown(
            max((s for n, s in self.stragglers.items() if n in placed),
                default=1.0), t,
        )

    def _on_straggler(self, ev: FaultEvent, t: float) -> None:
        node = ev.nodes[0]
        if self.bound is None or node not in self.bound.placed:
            return  # only the LPJ's synchronous step is slowdown-sensitive
        outcome = self.bound.on_straggler(node, t)
        if outcome is not None:  # live-migrated away: no lasting slowdown
            self.straggler_swaps += 1
            self.tracker.add_repair(outcome)
            self._sync_slowdown(t)
            return
        self.stragglers[node] = ev.slowdown
        self._push_recovery(t + ev.ttr_s, "destraggle", node)
        self._sync_slowdown(t)

    # ------------------------------------------------------------ recoveries
    def _push_recovery(self, t: float, kind: str, node: int) -> None:
        heapq.heappush(self._recoveries, (t, self._rseq, kind, node))
        self._rseq += 1

    def on_recovery(self, t: float) -> None:
        _, _, kind, node = heapq.heappop(self._recoveries)
        if kind == "destraggle":
            self.stragglers.pop(node, None)
            self._sync_slowdown(t)
            return
        self.n_recoveries += 1
        if self.bound is not None and node in self.bound.dead:
            self.bound.dead.discard(node)
            if node not in self.bound.placed:
                self.policy.cluster.release([node])  # was replaced: free again
            # else: never-repair / pending ladder -- node is back in service
        elif node in self.quarantined:
            self.quarantined.discard(node)
            self.policy.cluster.release([node])
        else:
            return
        if self.bound is None:
            return
        dead_placed = self.bound.dead & self.bound.placed
        if self.pending_repair and dead_placed:
            self._repair(sorted(dead_placed), t)  # retry the ladder
            dead_placed = self.bound.dead & self.bound.placed
        if not dead_placed and self.tracker.started:
            self.pending_repair = False
            self.tracker.resume(t)
        # Capacity came back: re-grow a shrunk placement (the grow half of
        # elastic shrink/grow -- clone a DP replica from a live peer).
        if not dead_placed and getattr(self.bound, "can_grow", None):
            while self.bound.can_grow():
                outcome = self.bound.grow(t)
                if outcome is None:
                    break
                self.grows += 1
                self.tier_hist["grow"] = self.tier_hist.get("grow", 0) + 1
                self.tracker.add_repair(outcome)
                self._sync_slowdown(t)  # grow may re-pick a known straggler

    # -------------------------------------------------- preemption cascade
    def _claim(self, n: int, domain: Optional[int] = None) -> list[int]:
        """Evict preemptable running queue jobs until ``n`` nodes are free
        (in ``domain`` if given); evicted jobs requeue and rerun later.
        Returns the freed node ids."""
        cluster = self.policy.cluster
        freed: list[int] = []

        def enough() -> bool:
            if domain is None:
                return len(freed) >= n
            return sum(1 for f in freed
                       if cluster.domain_of(f) == domain) >= n

        for job in sorted(self.policy.running.values(), key=lambda j: j.job_id):
            if enough():
                break
            if not job.preemptable:
                continue
            if domain is not None and not any(
                cluster.domain_of(x) == domain for x in job.nodes
            ):
                continue
            nodes = list(job.nodes)
            self.policy.requeue(job.job_id)
            freed.extend(nodes)
        if freed:
            self.cascades += 1
        return freed

    # ---------------------------------------------------------------- result
    def result_fields(self, t_end: float) -> dict:
        """The fault-side fields of :class:`SimResult`."""
        stats = self.tracker.finalize(t_end) if self.tracker.started else None
        bound = self.bound
        return dict(
            failed_nodes=self.failed_nodes,
            lpj_replans=self.replans,
            repair_tiers=dict(self.tier_hist),
            goodput=stats.goodput if stats else None,
            effective_training_s=stats.effective_s if stats else 0.0,
            lost_work_s=stats.lost_work_s if stats else 0.0,
            repair_downtime_s=stats.downtime_s if stats else 0.0,
            halted_s=stats.halted_s if stats else 0.0,
            n_faults=self.n_faults,
            n_fault_recoveries=self.n_recoveries,
            preemption_cascades=self.cascades,
            fault_killed_jobs=self.killed_jobs,
            straggler_swaps=self.straggler_swaps,
            lpj_shrinks=getattr(bound, "shrunk_rows", 0) if bound else 0,
            lpj_grows=self.grows,
            lpj_capacity_final=stats.capacity if stats else 1.0,
        )
