#!/usr/bin/env python3
"""The JAX reference's trainer beside the port's at minicpm-2b's published
widths, on the CPU: does the loss that rises at peak lr 1e-3 rise in the
reference too, and do the two compute the same history?

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 lr_witness.py

minicpm-2b at its published widths (d_model 2304, 36 heads of 64, d_ff 5760,
vocab 122753 padded to 122880, tied embeddings) cut to ``--layers`` layers
(2), fp32 weights and compute, no remat: ``--steps`` (8) steps of
``SyntheticDataset(seed 0)`` batches of 4 x 1024 tokens under the config's
WSD schedule at peak lr ``--peak-lr`` (1e-3) with 2 warm-up steps, through
the reference's ``Trainer`` and the port's, both from the reference's init
(``PRNGKey(0)``), carried across by ``repro_torch.convert``.  Each trainer
runs in a process of its own (one at a time, so the memory of one run is
the peak: about 20 GB at the defaults) and writes its final checkpoint into
a temporary directory under ``build/`` that is removed after it.

Prints one JSON line per trainer (its loss history), then one with both
histories and their largest relative difference, which
``tests/test_torch_train.py``'s 12-step history test holds to 1e-4 at the
reduced widths.  ``--reduced`` runs the config's reduced widths instead (a
quick check of the script).  At the defaults each trainer takes minutes.
Like the tests, this is the only kind of file that imports both packages.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))


def config(args, port: bool):
    if port:
        from repro_torch.configs import get_config
    else:
        from repro.configs import get_config
    cfg = get_config("minicpm-2b")
    return cfg.reduced() if args.reduced else dataclasses.replace(cfg, n_layers=args.layers)


def reference_init(cfg):
    """The reference's parameters at PRNGKey(0), as numpy fp32."""
    import jax
    import numpy as np

    from repro.models import ModelOptions, build_model

    model = build_model(cfg, ModelOptions(compute_dtype="float32", remat=False))
    return jax.tree.map(lambda a: np.asarray(a, np.float32), model.init(jax.random.PRNGKey(0)))


def side(args) -> dict:
    """One trainer's run; ``args.side`` is "reference" or "port"."""
    port = args.side == "port"
    sched = dict(name="wsd", peak_lr=args.peak_lr, warmup_steps=2, total_steps=args.steps)
    tcfg = dict(total_steps=args.steps, ckpt_every=args.steps, log_every=1)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="lr_witness_", dir=build) as ckpt:
        if port:
            import torch

            from repro_torch.convert import from_jax_params
            from repro_torch.data import SyntheticDataset
            from repro_torch.models import ModelOptions, build_model
            from repro_torch.optim import AdamWConfig, get_schedule
            from repro_torch.train import Trainer, TrainerConfig

            cfg = config(args, port=True)
            init = reference_init(config(args, port=False))
            model = build_model(cfg, ModelOptions("float32", "float32", remat=False), device="cpu")
            model.init = lambda generator: from_jax_params(init, cfg, torch.float32, "cpu")
            trainer = Trainer(model, SyntheticDataset(cfg.vocab, args.seq, args.batch, seed=0),
                              AdamWConfig(lr=get_schedule(**sched)), ckpt,
                              TrainerConfig(**tcfg))
        else:
            from repro.data import SyntheticDataset
            from repro.models import ModelOptions, build_model
            from repro.optim import AdamWConfig, get_schedule
            from repro.train import Trainer, TrainerConfig

            cfg = config(args, port=False)
            model = build_model(cfg, ModelOptions(compute_dtype="float32", remat=False))
            trainer = Trainer(model, SyntheticDataset(cfg.vocab, args.seq, args.batch, seed=0),
                              AdamWConfig(lr=get_schedule(**sched)), ckpt,
                              TrainerConfig(**tcfg))
        t0 = time.perf_counter()
        trainer.run()
        seconds = time.perf_counter() - t0
    return {"trainer": args.side, "model": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab, "batch": [args.batch, args.seq],
            "peak_lr": args.peak_lr, "loss": trainer.losses(),
            "grad_norm": [h["grad_norm"] for h in trainer.history if "grad_norm" in h],
            "cpu_seconds": seconds}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--peak-lr", type=float, default=1e-3)
    ap.add_argument("--reduced", action="store_true", help="the config's reduced widths")
    ap.add_argument("--side", choices=("reference", "port"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        print(json.dumps(side(args)), flush=True)
        return
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    runs = {}
    for name in ("reference", "port"):
        cmd = [sys.executable, os.path.abspath(__file__), *sys.argv[1:], "--side", name]
        out = subprocess.run(cmd, env=env, capture_output=True, text=True)
        if out.returncode != 0:
            raise SystemExit(f"{name} trainer: exit {out.returncode}\n{out.stderr[-4000:]}")
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[name] = json.loads(line)["loss"]
    ref, port = runs["reference"], runs["port"]
    rel = max(abs(p - r) / abs(r) for p, r in zip(port, ref))
    print(json.dumps({"reference_loss": ref, "port_loss": port, "max_rel_diff": rel,
                      "agree_at_rtol_1e-4": len(ref) == len(port) and rel <= 1e-4,
                      "reference_rose": ref[-1] > ref[0], "port_rose": port[-1] > port[0]}),
          flush=True)


if __name__ == "__main__":
    main()
