"""Device milliseconds a window step from the start to the end of
``loss_and_grads`` (CUDA events around the call the step makes), mean a step."""


def read(run):
    return sum(run.fwd_bwd_ms) / len(run.fwd_bwd_ms) if run.fwd_bwd_ms else None
