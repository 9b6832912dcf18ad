"""This process's CPU time over an interval, as cores' worth (``os.times``):
printed beside a run's window, so that a step paced by its host thread (one
core's worth) can be told from one that waits on the device.  The machine's
own counters (``/proc/stat``, the load average) are not read: inside a
container they need not describe the host."""

from __future__ import annotations

import os
import time


def sample() -> tuple:
    return time.perf_counter(), sum(os.times()[:2])


def describe(a: tuple, b: tuple) -> str:
    return f"this process {(b[1] - a[1]) / max(b[0] - a[0], 1e-9):.2f} cores"
