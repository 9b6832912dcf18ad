#!/usr/bin/env python3
"""Trains minicpm-2b at full width and depth for a few steps at two peak
learning rates, through the port's kernels and through their plain versions,
and prints each run's loss history: is a loss that rises at peak lr 1e-3 the
kernels' doing or the recipe's, and is the tied embedding's small init the
cause?

    python3 lr_probe.py

Each run is ``chip_smoke.py``'s ``train`` phase at another setting: bf16
compute on fp32 masters and AdamW state, remat, ``SyntheticDataset(seed 0)``
batches of 4 x 1024 tokens through ``make_train_step``, the config's WSD
schedule with 2 warm-up steps, weights from seed 0.  The runs:

- ``kernels`` at peak lr 1e-4 and 1e-3;
- ``plain`` at 1e-3: ``ops.rmsnorm`` and ``ops.flash_attention`` replaced by
  the plain versions, differentiated by autograd (no kernel launches);
- ``kernels`` at 1e-3 with the tied embedding's draw scaled from std
  1/sqrt(padded vocab) to 1/sqrt(d_model), the fan-in scale of the logits
  product it also serves.

Prints the card as ``nvidia-smi`` names it, then one JSON line per run.
Needs one CUDA device.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticDataset  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, get_schedule, init_opt_state  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

BATCH, SEQ, STEPS = 4, 1024, 8
RUNS = [  # (route, peak lr, scale the tied embedding to 1/sqrt(d_model))
    ("kernels", 1e-4, False),
    ("kernels", 1e-3, False),
    ("plain", 1e-3, False),
    ("kernels", 1e-3, True),
]


def run(cfg, dev: torch.device, route: str, peak_lr: float, wide_embed: bool) -> dict:
    model = build_model(cfg, ModelOptions("float32", "bfloat16", remat=True), dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    if wide_embed:
        params["embed"]["tokens"].mul_(math.sqrt(cfg.padded_vocab / cfg.d_model))
    opt_state = init_opt_state(params)
    step_fn = make_train_step(model, AdamWConfig(lr=get_schedule(cfg.lr_schedule, peak_lr, 2, STEPS)))
    data = SyntheticDataset(cfg.vocab, SEQ, BATCH, seed=0)
    plain = mock.patch.multiple(ops, rmsnorm=ref.rmsnorm_ref, flash_attention=ref.flash_attention_ref)
    losses, gnorms, ms = [], [], []
    ops.reset_launch_counts()
    with plain if route == "plain" else contextlib.nullcontext():
        for step in range(STEPS):
            batch = data.batch(step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(metrics["loss"].item())
            gnorms.append(metrics["grad_norm"].item())
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"route": route, "peak_lr": peak_lr,
            "embed_init_std": 1 / math.sqrt(cfg.d_model if wide_embed else cfg.padded_vocab),
            "loss": losses, "grad_norm": gnorms, "ms": ms,
            "loss_fell": losses[-1] < losses[0], "launches": ops.launch_counts()}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("lr_probe.py needs a CUDA device: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0], flush=True)
    _build.build_all()
    cfg = get_config("minicpm-2b")
    for route, peak_lr, wide_embed in RUNS:
        print(json.dumps({"model": cfg.name, "n_layers": cfg.n_layers, "batch": [BATCH, SEQ],
                          **run(cfg, dev, route, peak_lr, wide_embed)}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
