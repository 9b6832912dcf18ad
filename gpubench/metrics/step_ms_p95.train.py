"""The 95th percentile (nearest rank) of the window's host step times, start to
start: the host's tail, reported and not judged."""

from gpubench.window import percentile


def read(run):
    return 1e3 * percentile(run.window.step_s, 95) if run.window.step_s else None
