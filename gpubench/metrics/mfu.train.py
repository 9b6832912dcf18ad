"""The whole step's share of the card's bf16 peak over the window, in %: model
FLOPs a step (``counts.model_flops``: 6 N tokens + 3 x causal attention's
forward, no recompute) times the window's steps, over the window's time times
989 TFLOP/s."""

from gpubench import counts


def read(run):
    flops = counts.model_flops(run.arch, run.traffic["batch"], run.traffic["seq"])
    return 100.0 * run.window.steps * flops / (run.window.seconds * counts.PEAK_FLOPS)
