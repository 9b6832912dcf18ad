"""Quickstart: train a small LM end to end with the public API.

config -> model -> synthetic data -> AdamW + WSD schedule -> fault-tolerant
trainer with checkpointing, on the card (``--device cpu`` for the host)::

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.data import SyntheticDataset
from repro_torch.models import ModelOptions, build_model
from repro_torch.optim import AdamWConfig, get_schedule
from repro_torch.train import Trainer, TrainerConfig


def main(device: str | None = None) -> dict:
    cfg = get_config("minicpm-2b").reduced()   # llama-like, tied embeddings
    model = build_model(cfg, ModelOptions(param_dtype="float32", compute_dtype="float32",
                                          remat=False), device=device or "cuda")
    dataset = SyntheticDataset(cfg.vocab, seq_len=64, global_batch=8, seed=0)

    steps = 200
    schedule = get_schedule("wsd", peak_lr=3e-3, warmup_steps=10, total_steps=steps)
    opt = AdamWConfig(lr=schedule, weight_decay=0.01)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        trainer = Trainer(
            model, dataset, opt, ckpt_dir=ckpt_dir,
            cfg=TrainerConfig(total_steps=steps, ckpt_every=50, log_every=20),
            on_step=lambda h: print(
                f"step {h['step']:4d}  loss {h['loss']:.4f}  "
                f"gnorm {h['grad_norm']:.2f}", flush=True
            ),
        )
        trainer.run()
        losses = trainer.losses()
        print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")
        assert losses[-1] < losses[0], "loss must decrease on the Markov stream"
        kept = trainer.ckpt.steps()
        print(f"checkpoints kept: {kept}")
    print("OK")
    return {"losses": losses, "checkpoints": kept}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
