"""Reduces ``torch.profiler`` traces of the traced steps to what the
per-layer readers and the result's ``device`` and ``breakdown`` take.

The measured window of a ``--trace 1`` run is recorded with the device alone
(``device_summary``), which costs the host little: the window runs from a
drained device to the synchronize after the last step, on the host's clock,
so it holds the gaps between steps, and its busy time is the union of every
device activity (kernels, copies, fills) in it.  A short segment after the
window also records host ops (``summarize``), which slows the host: it gives
each op's device time and calls and the idle gaps by the host op open at
their start, inside the host range ``gpubench.window``.  A device activity belongs to every host op that
was open on the launching thread when it was launched (matched by the
launch's correlation id), so ``op_kernel_s["_FlashAttention"]`` is the device
time of the kernels the flash forward's autograd Function launched, whatever
they are.  Annotations that mirror host ranges on the device are not work."""

from __future__ import annotations

import dataclasses
import heapq
from collections import defaultdict

WINDOW = "gpubench.window"
STEP = "gpubench.step"      # a step of the harness's loop: a gap inside it, with no op open, is the program's Python
NO_OP = "host (no op open)"


@dataclasses.dataclass
class Activity:          # on the device
    name: str
    start: int           # ns
    end: int
    correlation: int


@dataclasses.dataclass
class HostOp:            # a host op or runtime call, on one thread
    name: str
    thread: int
    start: int
    end: int
    correlation: int = -1   # a runtime launch's correlation id, else -1


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernel_s: dict           # device seconds by activity name
    device_ops: list         # [[name, seconds]]: the 10 heaviest
    op_kernel_s: dict = dataclasses.field(default_factory=dict)   # device seconds launched
    op_calls: dict = dataclasses.field(default_factory=dict)      # inside each host op, its ranges
    idle_gaps: list = dataclasses.field(default_factory=list)     # [[host op at a gap's start, s]]

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _top(seconds: dict, top: int) -> list:
    return [[n[:96], v] for n, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:top]]


def device_summary(activities: list, window_s: float, top: int = 10) -> Summary:
    """Busy time and time by activity over a window timed on the host."""
    busy = _union([(a.start, a.end) for a in activities])
    kernel_s: dict = defaultdict(float)
    for a in activities:
        kernel_s[a.name] += (a.end - a.start) * 1e-9
    return Summary(window_s, sum(e - s for s, e in busy) * 1e-9, dict(kernel_s), _top(kernel_s, top))


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _open_at(ops: list, times: list):
    """For each time in ascending ``times``, the ops (of ``ops`` sorted by
    start) open at it, innermost (latest started) last."""
    heap: list = []
    i = 0
    for t in times:
        while i < len(ops) and ops[i].start <= t:
            heapq.heappush(heap, (ops[i].end, i))
            i += 1
        while heap and heap[0][0] < t:
            heapq.heappop(heap)
        live = sorted((ops[j] for end, j in heap if end >= t), key=lambda o: (o.start, -o.end))
        yield live


def summarize(activities: list, host: list, top: int = 10) -> Summary:
    windows = [h for h in host if h.name == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"{len(windows)} ranges named {WINDOW!r} in the trace")
    w0, w1 = windows[0].start, windows[0].end
    # a host range also shows on the device's timeline as an annotation: not work
    ranges = {h.name for h in host}
    inside = [a for a in activities if a.end > w0 and a.start < w1 and a.name not in ranges]
    clipped = [(max(a.start, w0), min(a.end, w1)) for a in inside]
    busy = _union(clipped)
    kernel_s: dict = defaultdict(float)
    for a, (s, e) in zip(inside, clipped):
        kernel_s[a.name] += (e - s) * 1e-9

    ops = sorted((h for h in host if h.correlation < 0 and h.name != WINDOW
                  and h.end > w0 and h.start < w1), key=lambda h: h.start)
    op_calls: dict = defaultdict(int)
    for h in ops:
        op_calls[h.name] += 1
    launches = {h.correlation: h for h in host if h.correlation >= 0}
    by_thread: dict = defaultdict(list)
    for h in ops:
        by_thread[h.thread].append(h)
    pending: dict = defaultdict(list)     # thread -> [(launch time, seconds)]
    for a, (s, e) in zip(inside, clipped):
        launch = launches.get(a.correlation)
        if launch is not None:
            pending[launch.thread].append((launch.start, (e - s) * 1e-9))
    op_kernel_s: dict = defaultdict(float)
    for thread, items in pending.items():
        items.sort()
        for (_, sec), open_ops in zip(items, _open_at(by_thread[thread], [t for t, _ in items])):
            for name in {o.name for o in open_ops}:
                op_kernel_s[name] += sec

    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if prev < w1:
        gaps.append((prev, w1))
    every = sorted((h for h in host if h.name != WINDOW), key=lambda h: h.start)
    gap_s: dict = defaultdict(float)
    for (s, e), open_ops in zip(gaps, _open_at(every, [s for s, _ in gaps])):
        gap_s[open_ops[-1].name if open_ops else NO_OP] += (e - s) * 1e-9

    return Summary((w1 - w0) * 1e-9, sum(e - s for s, e in busy) * 1e-9, dict(kernel_s),
                   _top(kernel_s, top), dict(op_kernel_s), dict(op_calls), _top(gap_s, top))


def _ns(event, what: str) -> int:
    if hasattr(event, f"{what}_ns"):
        return int(getattr(event, f"{what}_ns")())
    return int(getattr(event, f"{what}_us")() * 1000)


def events(prof, host_ops: bool = True) -> tuple:
    """(device activities, host ops) of a finished ``torch.profiler.profile``;
    without ``host_ops`` the second is empty."""
    from torch.autograd import DeviceType

    activities, host = [], []
    for ev in prof.profiler.kineto_results.events():
        on_device = ev.device_type() == DeviceType.CUDA
        if on_device and getattr(ev, "is_user_annotation", lambda: False)():
            continue
        if not (on_device or host_ops):
            continue
        start = _ns(ev, "start")
        end = start + _ns(ev, "duration")
        if on_device:
            activities.append(Activity(ev.name(), start, end, ev.correlation_id()))
        else:
            name = ev.name()
            runtime = name.startswith(("cuda", "cu")) and ev.correlation_id() > 0
            host.append(HostOp(name, ev.start_thread_id(), start, end,
                               ev.correlation_id() if runtime else -1))
    return activities, host
