"""The measured window: whole optimizer steps over all of their time.

It starts at a step boundary with the device drained, starts steps while
fewer than ``seconds`` have passed since it began, and ends when the device
has finished the last step started.  A rate is the work of every step started
over that whole time, never a median of steps and never a count of the steps
that happen to end inside a fixed time."""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable


@dataclasses.dataclass
class Window:
    steps: int                 # whole steps run
    seconds: float             # from the first step's start to the device's end of the last
    step_s: list               # host time of each step, start to start (the last to the end)

    def rate(self, work_a_step: float) -> float:
        return self.steps * work_a_step / self.seconds


def run_window(step: Callable[[], None], seconds: float, sync: Callable[[], None] = lambda: None,
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Run ``step`` until ``seconds`` have passed, then finish the step in
    flight; ``sync`` waits for the device (called before and after)."""
    sync()
    t0 = clock()
    starts = []
    while True:
        starts.append(clock())
        step()
        if clock() - t0 >= seconds:
            break
    sync()
    t1 = clock()
    ends = starts[1:] + [t1]
    return Window(len(starts), t1 - t0, [e - s for s, e in zip(starts, ends)])


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100)."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100 * len(ordered)) - 1)]
