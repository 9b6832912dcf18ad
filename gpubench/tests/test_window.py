"""The window counts whole steps over all of their time."""

from __future__ import annotations

from gpubench.window import percentile, run_window


class FakeClock:
    """Host time advances by each step's launch cost; the device drains at
    ``sync`` to the end of the work queued."""

    def __init__(self, launch_s: float, device_s: float):
        self.t, self.device_end, self.launch_s, self.device_s = 0.0, 0.0, launch_s, device_s

    def __call__(self) -> float:
        return self.t

    def step(self) -> None:
        self.device_end = max(self.device_end, self.t) + self.device_s
        self.t += self.launch_s

    def sync(self) -> None:
        self.t = max(self.t, self.device_end)


def test_a_step_in_flight_is_finished_and_counted_with_all_its_time():
    clock = FakeClock(launch_s=0.1, device_s=0.7)
    w = run_window(clock.step, 2.0, clock.sync, clock)
    # the host runs ahead: it starts steps until 2 s of host time have passed,
    # and the window waits for the device to finish all of them
    assert w.steps == 20
    assert abs(w.seconds - 20 * 0.7) < 1e-9
    assert abs(w.rate(4096) - 4096 / 0.7) < 1e-6
    assert abs(sum(w.step_s) - w.seconds) < 1e-9


def test_the_window_ends_at_the_first_step_boundary_past_its_length():
    clock = FakeClock(launch_s=0.6, device_s=0.0)
    w = run_window(clock.step, 2.0, clock.sync, clock)
    assert w.steps == 4 and abs(w.seconds - 2.4) < 1e-9   # 1.8 s < 2 s, so a fourth step
    assert abs(w.rate(1.0) - 4 / 2.4) < 1e-9


def test_percentile_is_the_nearest_rank():
    values = list(range(1, 101))
    assert percentile(values, 95) == 95
    assert percentile([3.0], 95) == 3.0
    assert percentile([1, 2, 3, 4], 50) == 2


def test_the_traced_idle_share_covers_the_whole_window(tiny_root):
    """The ``--trace 1`` run records the measured window itself: the idle
    share's window is the window's whole time, every step and gap in it."""
    import time

    import torch

    from gpubench import spec, train_cell

    cell = spec.load_cell("tiny-dense.train.4x64", tiny_root)
    run = train_cell.run(cell, 5, 0.3, True, torch.device("cpu"), time.perf_counter())
    assert run.window.steps >= 1
    assert run.trace.window_s == run.window.seconds and 0 <= run.trace.busy_s <= run.trace.window_s
    assert run.trace.op_calls.get("gpubench.step") == cell.traffic["traced_steps"]
