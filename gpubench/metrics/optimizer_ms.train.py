"""Device milliseconds a window step from the start to the end of
``adamw_update`` (CUDA events around the call the step makes), mean a step."""


def read(run):
    return sum(run.optimizer_ms) / len(run.optimizer_ms) if run.optimizer_ms else None
