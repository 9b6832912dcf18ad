"""Seconds from the process's start to the window's first step: imports, the
kernels' build (cached in the checkout's build/), the weights made from the
seed and the checked steps, which warm up every shape of the cell."""


def read(run):
    return run.setup_s
