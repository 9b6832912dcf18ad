"""LR schedules: linear warmup + cosine decay, and WSD (Warmup-Stable-Decay,
the MiniCPM schedule -- arXiv:2404.06395) used by the minicpm-2b config.

The reference's ``optim/schedule.py`` in numpy float32: each schedule maps a
step to the learning rate as a Python float, computed with the reference's
float32 operations in its order, so the host never waits for the device.
"""

from __future__ import annotations

import numpy as np

_F32 = np.float32


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step) -> float:
        step = _F32(step)
        warm = _F32(peak_lr) * step / _F32(max(warmup_steps, 1))
        prog = np.clip((step - _F32(warmup_steps)) / _F32(max(total_steps - warmup_steps, 1)),
                       _F32(0.0), _F32(1.0))
        cos = _F32(final_frac * peak_lr) + _F32((1 - final_frac) * peak_lr) * _F32(0.5) * (
            _F32(1) + np.cos(_F32(np.pi) * prog))
        return float(warm if step < warmup_steps else cos)

    return f


def wsd(peak_lr: float, warmup_steps: int, total_steps: int,
        decay_frac: float = 0.1, final_frac: float = 0.01):
    """Warmup-Stable-Decay: hold peak LR for most of training, then decay
    exponentially in the final ``decay_frac`` of steps."""
    decay_start = int(total_steps * (1.0 - decay_frac))

    def f(step) -> float:
        step = _F32(step)
        warm = _F32(peak_lr) * step / _F32(max(warmup_steps, 1))
        prog = np.clip((step - _F32(decay_start)) / _F32(max(total_steps - decay_start, 1)),
                       _F32(0.0), _F32(1.0))
        decay = _F32(peak_lr) * np.power(_F32(final_frac), prog)
        out = warm if step < warmup_steps else _F32(peak_lr)
        return float(decay if step >= decay_start else out)

    return f


def get_schedule(name: str, peak_lr: float, warmup_steps: int, total_steps: int):
    if name == "cosine":
        return warmup_cosine(peak_lr, warmup_steps, total_steps)
    if name == "wsd":
        return wsd(peak_lr, warmup_steps, total_steps)
    raise ValueError(f"unknown schedule {name!r}")
