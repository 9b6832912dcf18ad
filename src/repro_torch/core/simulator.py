"""Trace-driven cluster simulator (paper §6/§7.1, Appendix H).

Replays a job trace against a :class:`Cluster` under a pluggable queue
policy, recording the Appendix-H time series (allocation rate, retention
rate, queuing delay) and -- for LPJs -- the end-to-end throughput estimated
by the calibrated network model, which is how Figure 9 is reproduced
without 9600 physical GPUs.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Optional

import numpy as np

from repro_torch.core.comm_matrix import CommMatrix
from repro_torch.core.netmodel import NetModel, fabric_net_model, simulate_step_time
from repro_torch.core.queue import Job, QueuePolicy
from repro_torch.core.spread import Placement, max_hop_diameters, max_spreads


@dataclasses.dataclass
class TimePoint:
    t: float
    allocation_rate: float
    retention_rate: float
    queued: int


@dataclasses.dataclass
class SimResult:
    series: list[TimePoint]
    queue_delays: dict[int, float]
    preempted_at_lpj: int
    manual_preemptions: int    # non-preemptable squatters at LPJ arrival
    lpj_nodes: list[int]
    failed_nodes: list[int] = dataclasses.field(default_factory=list)
    lpj_replans: int = 0       # warm re-solves triggered by failure churn
    # Fault-model fields (DESIGN.md §11): populated when run(faults=...)
    # replays a FaultModel trace; defaults keep the failures= shim and all
    # pre-fault constructions bit-identical.
    repair_tiers: dict = dataclasses.field(default_factory=dict)
    goodput: Optional[float] = None
    effective_training_s: float = 0.0
    lost_work_s: float = 0.0
    repair_downtime_s: float = 0.0
    halted_s: float = 0.0
    n_faults: int = 0
    n_fault_recoveries: int = 0
    preemption_cascades: int = 0
    fault_killed_jobs: int = 0
    straggler_swaps: int = 0
    lpj_shrinks: int = 0
    lpj_grows: int = 0
    lpj_capacity_final: float = 1.0

    def mean_alloc(self) -> float:
        return float(np.mean([p.allocation_rate for p in self.series]))


class TraceSimulator:
    """Discrete-event replay: arrivals + completions + scheduling ticks.

    The default :meth:`run` path is the vectorized replay of DESIGN.md §10:
    no per-tick heap events, arrivals drained in sorted batches, only job
    completions on a heap.  ``legacy=True`` selects the pre-vectorization
    event loop (one heap event per tick, per-job queue passes) -- kept as
    the parity and speedup reference; both produce bit-identical
    :class:`SimResult` on the same trace.
    """

    def __init__(self, policy: QueuePolicy, tick: float = 60.0):
        self.policy = policy
        self.tick = tick

    def run(
        self,
        jobs: list[Job],
        t_end: float,
        lpj_plan: Optional[tuple] = None,
        plan_at: float = 0.0,
        failures: Optional[list[tuple[float, int]]] = None,
        legacy: bool = False,
        faults=None,
        repair="elastic",
        fault_costs=None,
    ) -> SimResult:
        """Replay ``jobs``; if ``lpj_plan=(comm, arrival, alpha, unit)`` is
        given, the LPJ is planned at ``plan_at`` and admitted at arrival.
        An optional fifth element selects the scheduling policy for this
        LPJ -- a registry name, chain spec ("mip,topo-aware"), or Scheduler
        instance -- overriding the queue policy's default.

        ``faults`` is the full fault-injection path (DESIGN.md §11): a
        :class:`repro_torch.faults.FaultModel` (its trace is generated against
        the cluster's fabric over ``[0, t_end)``) or a pre-generated
        ``FaultEvent`` list.  Hard faults kill whatever holds the node --
        queue jobs requeue, a running LPJ is repaired through ``repair``
        ("elastic" | "full" | "never" or a policy instance) -- transient
        faults return to service, stragglers slow the LPJ down, and
        :class:`SimResult` carries goodput / effective-training-time /
        repair-tier accounting.  ``fault_costs`` overrides the policy's
        :class:`repro_torch.faults.RepairCosts`.

        ``failures`` is the legacy shim: a list of ``(time, node_id)``
        hardware failures.  A failed node is quarantined (taken out of the
        free pool for good); if it belongs to a still-pending LPJ
        reservation, the plan is re-solved through
        :meth:`QueuePolicy.replan_lpj`, which hands warm-start-capable
        schedulers the previous placement plus the dirty set -- the churn
        path of DESIGN.md §8.2.  Its replay is bit-identical to pre-fault
        revisions."""
        driver = None
        if faults is not None:
            if failures is not None:
                raise ValueError("pass either faults= or the failures= shim")
            if legacy:
                raise ValueError("faults= requires the vectorized path")
            from repro_torch.faults import FaultDriver, FaultModel

            events = (
                faults.generate(self.policy.cluster.fabric, t_end)
                if isinstance(faults, FaultModel)
                else list(faults)
            )
            driver = FaultDriver(self.policy, events, repair=repair,
                                 costs=fault_costs)
        if legacy:
            return self._run_legacy(jobs, t_end, lpj_plan, plan_at, failures)
        return self._run_fast(jobs, t_end, lpj_plan, plan_at, failures, driver)

    @staticmethod
    def _tick_times(t_end: float, tick: float) -> list[float]:
        """Tick timestamps by iterated addition -- the exact float sequence
        the legacy loop produced, so replays stay bit-identical."""
        out = []
        t = 0.0
        while t <= t_end:
            out.append(t)
            t += tick
        return out

    def _run_fast(self, jobs, t_end, lpj_plan, plan_at, failures,
                  driver=None) -> SimResult:
        # Structural events (ticks, plan, lpj, failures) are walked with
        # index pointers in the legacy event-id order: at equal timestamps
        # arrivals come first, then tick < plan < lpj < fail < recover <
        # fault < finish (the fault-model streams slot in after the legacy
        # shim's "fail"; recoveries beat same-time faults so a returning
        # node can serve the repair).  Only finishes -- the one stream
        # created during the run -- live on a heap.
        arrivals = sorted(jobs, key=lambda j: j.arrival)  # stable, like eids
        arr_t = np.array([j.arrival for j in arrivals], dtype=float)
        ticks = self._tick_times(t_end, self.tick)
        plan_ev = lpj_ev = None
        if lpj_plan is not None:
            comm, arrival, alpha, unit, *rest = lpj_plan
            scheduler = rest[0] if rest else None
            plan_ev = (plan_at, (comm, arrival, alpha, unit, scheduler))
            lpj_ev = arrival
        fails = sorted(
            enumerate(failures or []), key=lambda e: e[1][0]
        )  # stable in list order
        finishes: list[tuple[float, int, Job]] = []
        fseq = 0

        series: list[TimePoint] = []
        delays: dict[int, float] = {}
        submit_time: dict[int, float] = {}
        preempted_n = manual_n = replans = 0
        lpj_nodes: list[int] = []
        failed: list[int] = []

        ai = ti = fi = 0
        plan_done = plan_ev is None
        lpj_done = lpj_ev is None
        policy = self.policy

        while True:
            # Next structural event: min over streams, category priority
            # breaking timestamp ties (the legacy push order).
            best, best_kind = np.inf, None
            if ti < len(ticks):
                best, best_kind = ticks[ti], "tick"
            if not plan_done and plan_ev[0] < best:
                best, best_kind = plan_ev[0], "plan"
            if not lpj_done and lpj_ev < best:
                best, best_kind = lpj_ev, "lpj"
            if fi < len(fails) and fails[fi][1][0] < best:
                best, best_kind = fails[fi][1][0], "fail"
            if driver is not None:
                rt = driver.peek_recovery()
                if rt is not None and rt < best:
                    best, best_kind = rt, "recover"
                ft = driver.peek_fault()
                if ft is not None and ft < best:
                    best, best_kind = ft, "fault"
            if finishes and finishes[0][0] < best:
                best, best_kind = finishes[0][0], "finish"
            if best_kind is None or best > t_end:
                break
            t = best

            # Drain every arrival at or before t (arrivals always precede
            # same-time structural events) in one batch.
            if ai < len(arrivals):
                hi = int(np.searchsorted(arr_t, t, side="right"))
                for j in arrivals[ai:hi]:
                    submit_time[j.job_id] = j.arrival
                    policy.submit(j)
                ai = hi

            if best_kind == "tick":
                ti += 1
                started = policy.schedule_tick(t)
                for job in started:
                    delays[job.job_id] = t - submit_time[job.job_id]
                    heapq.heappush(finishes, (t + job.duration, fseq, job))
                    fseq += 1
                series.append(
                    TimePoint(
                        t=t,
                        allocation_rate=policy.allocation_rate(),
                        retention_rate=policy.retention_rate(),
                        queued=len(policy.queue),
                    )
                )
            elif best_kind == "plan":
                comm, arrival, alpha, unit, scheduler = plan_ev[1]
                policy.plan_lpj(comm, arrival, alpha, unit=unit,
                                scheduler=scheduler)
                plan_done = True
            elif best_kind == "lpj":
                lpj_nodes, preempted = policy.admit_lpj(t)
                preempted_n = len(preempted)
                manual_n = sum(1 for j in preempted if not j.preemptable)
                lpj_done = True
                if driver is not None:
                    driver.on_lpj_admitted(t)
            elif best_kind == "recover":
                driver.on_recovery(t)
            elif best_kind == "fault":
                driver.on_fault(t)
            elif best_kind == "fail":
                node = int(fails[fi][1][1])
                fi += 1
                if policy.cluster.is_free(node):
                    policy.cluster.allocate([node])  # quarantine
                failed.append(node)
                lpj = policy.lpj
                if (
                    lpj is not None and lpj.result is not None
                    and t < lpj.arrival
                    and node in lpj.reserved_nodes
                ):
                    policy.replan_lpj(dirty_nodes=frozenset(failed))
                    replans += 1
            else:  # finish -- drain the whole same-time batch
                while finishes and finishes[0][0] <= t:
                    ft, _, job = heapq.heappop(finishes)
                    # A fault-killed job requeues and restarts later, so a
                    # stale finish event may still reference it; only the
                    # event pushed for the *current* start completes it
                    # (float-exact: both sides are job.start + job.duration).
                    if (
                        job.job_id in policy.running
                        and job.start is not None
                        and job.start + job.duration == ft
                    ):
                        policy.complete(job.job_id)

        result = SimResult(
            series=series,
            queue_delays=delays,
            preempted_at_lpj=preempted_n,
            manual_preemptions=manual_n,
            lpj_nodes=lpj_nodes,
            failed_nodes=failed,
            lpj_replans=replans,
        )
        if driver is not None:
            for k, v in driver.result_fields(t_end).items():
                setattr(result, k, v)
        return result

    def _run_legacy(self, jobs, t_end, lpj_plan, plan_at, failures) -> SimResult:
        """Pre-vectorization replay: every tick is a heap event and the
        queue pass is :meth:`QueuePolicy.schedule_tick_legacy`."""
        events: list[tuple[float, int, str, object]] = []
        eid = 0

        def push(t, kind, payload):
            nonlocal eid
            heapq.heappush(events, (t, eid, kind, payload))
            eid += 1

        for j in jobs:
            push(j.arrival, "arrive", j)
        for t in self._tick_times(t_end, self.tick):
            push(t, "tick", None)
        if lpj_plan is not None:
            comm, arrival, alpha, unit, *rest = lpj_plan
            scheduler = rest[0] if rest else None
            push(plan_at, "plan", (comm, arrival, alpha, unit, scheduler))
            push(arrival, "lpj", None)
        for ft, node in failures or []:
            push(ft, "fail", node)

        series: list[TimePoint] = []
        delays: dict[int, float] = {}
        submit_time: dict[int, float] = {}
        preempted_n = 0
        manual_n = 0
        lpj_nodes: list[int] = []
        failed: list[int] = []
        replans = 0

        while events:
            t, _, kind, payload = heapq.heappop(events)
            if t > t_end:
                break
            if kind == "arrive":
                job = payload
                submit_time[job.job_id] = t
                self.policy.submit(job)
            elif kind == "plan":
                comm, arrival, alpha, unit, scheduler = payload
                self.policy.plan_lpj(comm, arrival, alpha, unit=unit,
                                     scheduler=scheduler)
            elif kind == "fail":
                node = int(payload)
                if self.policy.cluster.is_free(node):
                    self.policy.cluster.allocate([node])  # quarantine
                failed.append(node)
                lpj = self.policy.lpj
                if (
                    lpj is not None and lpj.result is not None
                    and t < lpj.arrival
                    and node in lpj.reserved_nodes
                ):
                    self.policy.replan_lpj(dirty_nodes=frozenset(failed))
                    replans += 1
            elif kind == "lpj":
                lpj_nodes, preempted = self.policy.admit_lpj(t)
                preempted_n = len(preempted)
                manual_n = sum(1 for j in preempted if not j.preemptable)
            elif kind == "tick":
                started = self.policy.schedule_tick_legacy(t)
                for job in started:
                    delays[job.job_id] = t - submit_time[job.job_id]
                    push(t + job.duration, "finish", job)
                series.append(
                    TimePoint(
                        t=t,
                        allocation_rate=self.policy.allocation_rate(),
                        retention_rate=self.policy.retention_rate(),
                        queued=len(self.policy.queue),
                    )
                )
            elif kind == "finish":
                job = payload
                if job.job_id in self.policy.running:
                    self.policy.complete(job.job_id)
        return SimResult(
            series=series,
            queue_delays=delays,
            preempted_at_lpj=preempted_n,
            manual_preemptions=manual_n,
            lpj_nodes=lpj_nodes,
            failed_nodes=failed,
            lpj_replans=replans,
        )


# ---------------------------------------------------------------------------
# LPJ throughput simulation (Figures 5 / 9 reproduction path).
# ---------------------------------------------------------------------------

def throughput_of_placement(
    placement: Placement,
    net: Optional[NetModel] = None,
    steps: int = 1,
    seed: int = 0,
    **step_kw,
) -> dict:
    """Simulated tokens/sec of an LPJ under a placement.

    The spread and hop diameter of the slowest DP and PP group feed the
    calibrated BusBw model; throughput = tokens per step / simulated step
    time.  ``net`` defaults to the placement's per-fabric model
    (:func:`repro_torch.core.netmodel.fabric_net_model`) -- on ``clos`` that is
    output-identical to the legacy :class:`NetModel`.
    """
    net = net or fabric_net_model(placement.cluster.fabric)
    rng = np.random.default_rng(seed)
    comm = placement.comm
    dp_s, pp_s = max_spreads(placement)
    dp_h, pp_h = max_hop_diameters(placement)
    times = [
        simulate_step_time(comm, dp_s, pp_s, net=net, rng=rng,
                           dp_hops=dp_h, pp_hops_diameter=pp_h, **step_kw)
        for _ in range(steps)
    ]
    model = comm.job.model
    tokens = model.global_batch * model.seq_len
    mean_t = float(np.mean([b.total for b in times]))
    return {
        "dp_spread": dp_s,
        "pp_spread": pp_s,
        "dp_hop_diameter": dp_h,
        "pp_hop_diameter": pp_h,
        "fabric": placement.cluster.fabric.kind,
        "step_time_s": mean_t,
        "tokens_per_s": tokens / mean_t,
        "comm_fraction": float(np.mean([b.comm_fraction() for b in times])),
        "breakdown": times[-1],
    }


def poisson_trace(
    n_jobs: int,
    mean_interarrival: float,
    mean_duration: float,
    max_nodes: int,
    seed: int = 0,
    preemptable_frac: float = 0.15,
) -> list[Job]:
    """Synthetic open-loop trace with lognormal durations (cluster traces
    are heavy-tailed [3]).

    All random fields are drawn in one vectorized pass per field (arrival
    gaps, size exponents, durations, metadata), so generating a month-scale
    100k-job trace is milliseconds, not seconds.

    .. note:: **Seed compatibility.** Two changes in DESIGN.md §10 moved
       this generator off the pre-vectorization random stream, so a given
       ``seed`` yields a *different* (equally valid) trace than older
       revisions: (1) draws are batched per field instead of interleaved
       per job, and (2) the size-exponent upper bound is now inclusive --
       the old ``rng.integers(0, log2(max_nodes))`` could never emit a job
       of ``max_nodes`` nodes.
    """
    rng = np.random.default_rng(seed)
    n = int(n_jobs)
    arrivals = np.cumsum(rng.exponential(mean_interarrival, size=n))
    max_exp = int(np.log2(max(max_nodes, 2)))
    sizes = 2 ** rng.integers(0, max_exp + 1, size=n)  # inclusive of max
    durs = rng.lognormal(np.log(mean_duration), 0.8, size=n)
    drives = rng.integers(0, 4, size=n)
    depts = rng.integers(0, 6, size=n)
    jct_noise = rng.uniform(0.7, 1.3, size=n)
    preemptable = rng.random(size=n) < preemptable_frac
    jobs = []
    for i in range(n):
        size, dur = int(sizes[i]), float(durs[i])
        meta = dict(
            n_gpus=size * 8,
            n_cpus=size * 64,
            mem_gb=size * 512,
            n_drives=int(drives[i]),
            department=int(depts[i]),
            priority=0,
            hour_of_day=int(arrivals[i] / 3600) % 24,
            user_avg_jct=dur * float(jct_noise[i]),
        )
        jobs.append(
            Job(
                job_id=i,
                n_nodes=size,
                arrival=float(arrivals[i]),
                duration=dur,
                metadata=meta,
                preemptable=bool(preemptable[i]),
            )
        )
    return jobs
