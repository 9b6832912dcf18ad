"""100 x (window - union of the device's activity) / window over the whole
measured window of the traced run, the gaps between steps included: the same
two numbers as the result's ``device.busy_s`` and ``device.window_s``."""


def read(run):
    return 100.0 * run.trace.idle_share if run.trace is not None else None
