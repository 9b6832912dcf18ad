"""Tokens of every optimizer step of the window over all of the window's time
(``window.run_window``): whole steps only, the device drained at both ends."""


def read(run):
    return run.window.rate(run.tokens_per_step)
