"""End-to-end training driver: ``python -m repro_torch.launch.train --arch <id>``.

The reference's ``launch/train.py`` on one device: config -> model ->
synthetic data pipeline -> AdamW (+schedule) -> fault-tolerant Trainer with
checkpoint-restart, with the reference's flags and rules (``--full`` for the
published config, else ``reduced()``; ``remat`` on with ``--full``; compute in
fp32 when ``--devices`` is 0; fp32 master weights).  Runs on the card unless
``--device cpu`` is given.  The scheduling core is ported
(:mod:`repro_torch.core`, with the Arnold-ordered mesh in
:mod:`repro_torch.launch.mesh`), but the sharded run (``--devices``,
``--mesh-shape``) and the Arnold placement of it (``--arnold``,
``--scheduler``) wait for the parallelism layer (ROADMAP.md queue A item 6)
and raise.
"""

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--full", action="store_true",
                    help="use the full published config (default: reduced)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--devices", type=int, default=0,
                    help="devices of a sharded run (0 = single); not ported yet")
    ap.add_argument("--mesh-shape", default="2x4", help="dataxmodel of the sharded run")
    ap.add_argument("--arnold", action="store_true",
                    help="order mesh devices by the Arnold placement; not ported yet")
    ap.add_argument("--scheduler", default=None,
                    help="placement policy for --arnold; not ported yet")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.devices or args.arnold or args.scheduler is not None:
        raise NotImplementedError(
            "--devices/--arnold/--scheduler need the parallelism layer, not ported yet "
            "(ROADMAP.md queue A item 6; the scheduling core is ported as repro_torch.core); "
            "this launcher trains on one device")

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.optim import AdamWConfig, get_schedule
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    opts = ModelOptions(param_dtype="float32", compute_dtype="float32", remat=bool(args.full))
    model = build_model(cfg, opts, device=args.device)

    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = ((args.global_batch, cfg.n_patches, cfg.d_model), "float32")
    if cfg.family == "audio":
        extra["frames"] = ((args.global_batch, 24, cfg.d_model), "float32")
    ds = SyntheticDataset(cfg.vocab, args.seq_len, args.global_batch, seed=args.seed,
                          extra_specs=extra)
    schedule = get_schedule(cfg.lr_schedule, args.lr, warmup_steps=max(1, args.steps // 20),
                            total_steps=args.steps)
    opt = AdamWConfig(lr=schedule)

    trainer = Trainer(
        model, ds, opt, ckpt_dir=args.ckpt_dir,
        cfg=TrainerConfig(
            total_steps=args.steps, ckpt_every=args.ckpt_every,
            log_every=args.log_every, microbatches=args.microbatches,
            seed=args.seed,
        ),
        on_step=lambda h: print(
            f"step {h['step']:5d}  loss {h['loss']:.4f}  "
            f"gnorm {h['grad_norm']:.3f}  {h['step_time']*1e3:.0f} ms",
            flush=True,
        ),
    )
    trainer.run()

    losses = trainer.losses()
    if not losses:
        print(f"nothing to train: the checkpoint in {args.ckpt_dir} is at step "
              f"{trainer.ckpt.latest_step()}, --steps is {args.steps}")
        return 0
    print(f"done: first logged loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    sys.exit(main())
