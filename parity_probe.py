#!/usr/bin/env python3
"""Reads what ``chip_smoke.py``'s bf16 gradient rule can tell apart: zamba2-2.7b
at full width and 12 layers, fp32 masters, the loss and every parameter's
gradient on one batch of 4 x 1024 tokens, for a few seeds.

    python3 parity_probe.py [--seeds 4] [--layers 12]

Seed k takes its weights from seed 4 + k and its batch from
``SyntheticDataset(seed k)`` (k = 0 is ``zamba_train_parity``'s own input).
Per seed, the worst leaf's ||g - g_ref|| / ||g_ref|| (Frobenius), with the leaf:

- ``rule``: bf16 through the kernels against bf16 through the plain versions,
  what ``zamba_train_parity`` holds to 5e-2;
- ``control``: bf16 through the plain versions against fp32 through the plain
  versions, how far bf16 rounding alone moves a gradient;
- ``kernels_vs_fp32``: bf16 through the kernels against fp32 through the plain
  versions;
- ``fp32``: fp32 through the kernels against fp32 through the plain versions
  (``zamba_train_parity``'s fp32 rule, 1e-4);
- ``each_kernel_alone``: bf16 with one kernel (forward and backward) launched
  and the others plain, against bf16 through the plain versions.

Prints the card as ``nvidia-smi`` names it, one JSON line per seed, then one
line with the worst reading of each kind over the seeds.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

import chip_smoke as smoke
from repro_torch.configs import get_config
from repro_torch.data import SyntheticDataset
from repro_torch.kernels import _build
from repro_torch.models import ModelOptions, build_model
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import loss_and_grads
from repro_torch.train.train_step import batch_to_device


def grads(model, master, batch, plain: bool, keep: str | None = None) -> tuple[float, list]:
    """The loss and a copy of every gradient, through the kernels or (``plain``)
    through the plain versions but ``keep``'s."""
    if plain:
        with smoke.plain_kernels(keep):
            loss, _, tree = loss_and_grads(model, master, batch)
    else:
        loss, _, tree = loss_and_grads(model, master, batch)
    out = [g.detach().clone() for g in tree_leaves(tree)]
    torch.cuda.synchronize()
    return loss.item(), out


def worst(got: list, want: list, paths: list[str]) -> dict:
    """The worst leaf's relative distance (a NaN counts as worst), and the median."""
    rels = [((a - b).norm() / b.norm().clamp(min=1e-30)).item() for a, b in zip(got, want)]
    i = max(range(len(rels)), key=lambda j: (not math.isfinite(rels[j]), rels[j]))
    return {"worst": rels[i], "leaf": paths[i], "median": sorted(rels)[len(rels) // 2]}


def probe_seed(cfg, dev: torch.device, k: int) -> dict:
    batch = batch_to_device(
        SyntheticDataset(cfg.vocab, smoke.TRAIN_SEQ, smoke.TRAIN_BATCH, seed=k).batch(0), dev)
    fp32 = build_model(cfg, ModelOptions("float32", "float32", remat=False), dev)
    bf16 = build_model(cfg, ModelOptions("float32", "bfloat16", remat=False), dev)
    master = fp32.init(torch.Generator(device=dev).manual_seed(4 + k))
    paths = smoke.leaf_paths(master)
    loss_32p, g_32p = grads(fp32, master, batch, plain=True)
    _, g_32k = grads(fp32, master, batch, plain=False)
    out = {"seed": k, "weights_seed": 4 + k, "data_seed": k, "fp32": worst(g_32k, g_32p, paths)}
    del g_32k
    loss_16p, g_16p = grads(bf16, master, batch, plain=True)
    loss_16k, g_16k = grads(bf16, master, batch, plain=False)
    out["rule"] = worst(g_16k, g_16p, paths)
    out["control"] = worst(g_16p, g_32p, paths)
    out["kernels_vs_fp32"] = worst(g_16k, g_32p, paths)
    out["loss"] = {"fp32_plain": loss_32p, "bf16_plain": loss_16p, "bf16_kernels": loss_16k}
    del g_16k, g_32p
    out["each_kernel_alone"] = {}
    for kernel in smoke.PLAIN:
        _, g = grads(bf16, master, batch, plain=True, keep=kernel)
        out["each_kernel_alone"][kernel] = worst(g, g_16p, paths)
        del g
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=4)
    parser.add_argument("--layers", type=int, default=12)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("parity_probe.py needs a CUDA device: torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smoke.nvidia_smi_line(), flush=True)
    _build.build_all()
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), n_layers=args.layers)
    rows = []
    for k in range(args.seeds):
        rows.append(probe_seed(cfg, dev, k))
        print(json.dumps(rows[-1]), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"layers": args.layers, "seeds": args.seeds, **{
        kind: max(r[kind]["worst"] for r in rows)
        for kind in ("fp32", "rule", "control", "kernels_vs_fp32")}}), flush=True)


if __name__ == "__main__":
    main()
