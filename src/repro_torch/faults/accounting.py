"""Goodput accounting for an LPJ under churn (DESIGN.md §11.3).

*Goodput* is the fraction of elapsed wall-clock the LPJ spends making
retained forward progress:

    goodput = effective_training_s / (t_end - t_admit)

``effective_training_s`` accrues continuously while the job runs, scaled
by the **capacity factor** (< 1 after elastic shrinks: a job at k of K DP
replicas progresses at k/K speed) and divided by the active **straggler
slowdown** (a synchronous step runs at the slowest participant's pace).
Accrual pauses inside repair-downtime windows and while the job is
halted (unrepaired dead nodes); **lost work** (rollback to the last
checkpoint) is subtracted the moment a repair rolls back.

Everything here is plain interval arithmetic over *modeled* costs -- no
wall-clock reads -- so replays are deterministic.
"""

from __future__ import annotations

import dataclasses

from repro_torch.faults.repair import RepairOutcome


@dataclasses.dataclass(frozen=True)
class GoodputStats:
    """Final accounting of one tracked LPJ interval."""

    t_start: float
    t_end: float
    effective_s: float       # retained, capacity-weighted training seconds
    lost_work_s: float       # rollback losses (already subtracted)
    downtime_s: float        # modeled repair downtime (sum over repairs)
    halted_s: float          # time spent halted on unrepaired dead nodes
    capacity: float          # final DP capacity factor

    @property
    def elapsed_s(self) -> float:
        return self.t_end - self.t_start

    @property
    def goodput(self) -> float:
        return self.effective_s / self.elapsed_s if self.elapsed_s > 0 else 0.0


class GoodputTracker:
    """Accrues effective training time between simulator events.

    Drive it with monotone timestamps: :meth:`advance` before reading or
    changing state at an event, then :meth:`add_repair` /
    :meth:`set_slowdown` / :meth:`halt` / :meth:`resume` as the event
    dictates, and :meth:`finalize` once at the end.
    """

    def __init__(self):
        self.started = False

    def start(self, t: float) -> None:
        self.started = True
        self.t0 = t
        self.last = t
        self.effective = 0.0
        self.capacity = 1.0
        self.slowdown = 1.0
        self.stall_until = t
        self.halted_since: float | None = None
        self.lost = 0.0
        self.downtime = 0.0
        self.halted_total = 0.0

    def advance(self, t: float) -> None:
        if not self.started or t <= self.last:
            return
        lo = max(self.last, self.stall_until)
        if self.halted_since is None and t > lo:
            self.effective += (t - lo) * self.capacity / self.slowdown
        self.last = t

    def add_repair(self, outcome: RepairOutcome) -> None:
        """Account one repair batch: subtract the rollback, open the
        downtime window, adopt the post-repair capacity factor."""
        self.advance(outcome.t)
        self.downtime += outcome.downtime_s
        self.lost += outcome.lost_work_s
        self.effective = max(0.0, self.effective - outcome.lost_work_s)
        self.stall_until = max(self.stall_until,
                               outcome.t + outcome.downtime_s)
        self.capacity = outcome.capacity

    def set_slowdown(self, factor: float, t: float) -> None:
        self.advance(t)
        self.slowdown = max(1.0, factor)

    def halt(self, t: float) -> None:
        self.advance(t)
        if self.halted_since is None:
            self.halted_since = t

    def resume(self, t: float) -> None:
        self.advance(t)
        if self.halted_since is not None:
            self.halted_total += t - self.halted_since
            self.halted_since = None

    def finalize(self, t_end: float) -> GoodputStats:
        if not self.started:
            raise ValueError("tracker never started (LPJ never admitted)")
        self.advance(t_end)
        if self.halted_since is not None:
            self.halted_total += t_end - self.halted_since
            self.halted_since = t_end
        return GoodputStats(
            t_start=self.t0,
            t_end=t_end,
            effective_s=self.effective,
            lost_work_s=self.lost,
            downtime_s=self.downtime,
            halted_s=self.halted_total,
            capacity=self.capacity,
        )
