#!/usr/bin/env python3
"""Two numerical probes of the port's models on the CPU, at published widths.

    PYTHONPATH=src python3 cpu_probe.py flash-d          # ~10 s
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 cpu_probe.py xlstm-init [--reference]   # ~35 s

``flash-d``: whisper-tiny at full width and depth (fp32 masters from seed 4, one
sequence of 1500 frames and 448 tokens from ``chip_smoke.train_data``): each
gradient leaf of a bf16-compute ``loss_and_grads`` against the fp32 one (the
relative Frobenius difference; the worst and the median leaf), with the flash
attention's backward emulated in plain PyTorch as the kernels compute it: P
and dS rounded to bf16 where the tensor-core route multiplies them, and D =
rowsum(dO * O) taken from the bf16-rounded out, or from out plus what rounding
dropped (``out_res``), beside autograd through the plain forward.

``xlstm-init``: xlstm-350m at full width, 4 layers (one unit), fp32, 256
tokens: how far a 1e-7 relative perturbation of every RMSNorm output moves the
logits (and from which position on by more than 1e-3), and whether the
gradient is finite, with the sLSTM's recurrent weights drawn as the port draws
them (fan-in dh) and as the reference does (fan-in on n_heads: the port's
weights times sqrt(dh / n_heads)).  ``--reference`` also takes ``jax.grad`` of
the reference's model on the reference-scaled weights.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
from unittest import mock

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import loss_and_grads  # noqa: E402


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def emulated_flash(d_from_res: bool):
    """``ops.flash_attention`` for the CPU with the kernels' roundings: the
    forward's P V with P in bf16, its out rounded once; the backward's dV with
    P in bf16 and dQ, dK with dS in bf16, D from the rounded out or from the
    unrounded one (out + out_res)."""

    class Flash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal):
            scores = ref._scores(q, k, causal)
            lse = torch.logsumexp(scores, -1)
            o32 = _bf16(torch.exp(scores - lse[..., None])) @ ref._by_q_head(v, q.shape[1]).float()
            ctx.causal = causal
            ctx.save_for_backward(q, k, v, o32, lse)
            return o32.to(q.dtype)

        @staticmethod
        def backward(ctx, dout):
            q, k, v, o32, lse = ctx.saved_tensors
            hq, hd = q.shape[1], q.shape[3]
            p = torch.exp(ref._scores(q, k, ctx.causal) - lse[..., None])
            do = dout.float()
            dv = _bf16(p).transpose(-1, -2) @ do
            dp = do @ ref._by_q_head(v, hq).float().transpose(-1, -2)
            o = o32 if d_from_res else _bf16(o32)
            ds = _bf16(p * (dp - (do * o).sum(-1, keepdim=True)))
            scale = 1.0 / math.sqrt(hd)
            dq = ds @ ref._by_q_head(k, hq).float() * scale
            dk = ds.transpose(-1, -2) @ q.float() * scale
            return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None

    return lambda q, k, v, causal=True: Flash.apply(q, k, v, causal)


def leaf_diffs(got: list[torch.Tensor], want: list[torch.Tensor]) -> tuple[float, float]:
    rel = sorted(((g - w).norm() / w.norm().clamp(min=1e-30)).item() for g, w in zip(got, want))
    return rel[-1], rel[len(rel) // 2]


def flash_d() -> None:
    import chip_smoke as cs

    cfg = get_config("whisper-tiny")
    batch = {k: torch.from_numpy(v[:1]) for k, v in cs.train_data(cfg).batch(0).items()}
    m32 = build_model(cfg, ModelOptions("float32", "float32", remat=False), "cpu")
    master = m32.init(torch.Generator().manual_seed(4))

    def grads(model, patch) -> list[torch.Tensor]:
        with patch:
            _, _, g = loss_and_grads(model, master, batch)
        return [t.clone() for t in tree_leaves(g)]

    def patch(flash):
        return mock.patch.multiple(ops, rmsnorm=ref.rmsnorm_ref, flash_attention=flash)

    truth = grads(m32, patch(ref.flash_attention_ref))
    mb = build_model(cfg, ModelOptions("float32", "bfloat16", remat=False), "cpu")
    for name, flash in (("bf16, autograd through the plain forward", ref.flash_attention_ref),
                        ("bf16, D from the rounded out", emulated_flash(False)),
                        ("bf16, D from out + out_res", emulated_flash(True))):
        worst, median = leaf_diffs(grads(mb, patch(flash)), truth)
        print(f"{name}: worst leaf {worst:.4f}, median {median:.4f} of fp32's norm", flush=True)


def xlstm_init(reference: bool) -> None:
    cfg = dataclasses.replace(get_config("xlstm-350m"), n_layers=4)
    model = build_model(cfg, ModelOptions("float32", "float32", remat=False), "cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 257), generator=torch.Generator().manual_seed(9))
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    noise = torch.Generator().manual_seed(10)

    def noisy(x, scale, eps):
        y = ref.rmsnorm_ref(x, scale, eps)
        return y * (1 + 1e-7 * torch.randn(y.shape, generator=noise).to(y.dtype))

    for name, factor in (("fan-in dh (the port)", 1.0),
                         ("fan-in n_heads (the reference)", math.sqrt(model.dh / cfg.n_heads))):
        params = model.init(torch.Generator().manual_seed(8))
        for up in params["units"]:
            up["slstm"]["ssm"]["r_gates"].mul_(factor)
        with torch.no_grad(), mock.patch.object(ops, "rmsnorm", ref.rmsnorm_ref):
            a, _ = model.forward(params, batch)
        with torch.no_grad(), mock.patch.object(ops, "rmsnorm", noisy):
            b, _ = model.forward(params, batch)
        moved = (a - b)[0, :, :cfg.vocab].abs().amax(-1)
        first = (moved > 1e-3).nonzero()
        _, _, g = loss_and_grads(model, params, batch)
        finite = sum(bool(torch.isfinite(t).all()) for t in tree_leaves(g))
        print(f"{name}: r_gates std {params['units'][0]['slstm']['ssm']['r_gates'].std():.4f}; "
              f"logits moved {moved.max():.3g} (first position past 1e-3: "
              f"{first[0].item() if len(first) else None}); finite gradient leaves "
              f"{finite} of {len(tree_leaves(g))}", flush=True)
        if reference and factor != 1.0:
            import jax
            import jax.numpy as jnp
            import numpy as np

            from repro.configs import get_config as jax_get_config
            from repro.models import ModelOptions as JaxOptions
            from repro.models import build_model as jax_build_model
            from repro_torch.convert import to_jax_layout

            jm = jax_build_model(dataclasses.replace(jax_get_config("xlstm-350m"), n_layers=4),
                                 JaxOptions(compute_dtype="float32", remat=False))
            jp = jax.tree.map(jnp.asarray, to_jax_layout(params, cfg))
            jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
            jg = jax.grad(lambda p: jm.loss(p, jb)[0])(jp)
            leaves = jax.tree.leaves(jg)
            print(f"  the reference's jax.grad on these weights: finite leaves "
                  f"{sum(bool(np.isfinite(np.asarray(x)).all()) for x in leaves)} of {len(leaves)}",
                  flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("probe", choices=("flash-d", "xlstm-init"))
    parser.add_argument("--reference", action="store_true",
                        help="xlstm-init: also jax.grad of the reference's model")
    args = parser.parse_args()
    torch.manual_seed(0)
    if args.probe == "flash-d":
        flash_d()
    else:
        xlstm_init(args.reference)


if __name__ == "__main__":
    main()
