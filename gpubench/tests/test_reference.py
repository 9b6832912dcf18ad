"""The plain reference against the port at a tiny size on the CPU, both in
fp32: the same loss, gradients and first steps."""

from __future__ import annotations

import pytest
import torch

from gpubench import check, spec, train_cell, weights
from gpubench.reference import model as ref_model


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_loss_and_gradients_match_the_port_in_fp32(family):
    from gpubench.tests.tiny import tiny_config
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.train.train_step import loss_and_grads

    cfg = tiny_config(family, "float32")
    arch = cfg["arch"]
    model = build_model(ArchConfig(**arch), ModelOptions(**cfg["options"]), "cpu")
    template = build_model(ArchConfig(**arch), ModelOptions(**cfg["options"]), "meta").init()
    pspec = ref_model.param_spec(arch)
    params = weights.tree(weights.make(pspec, 7, "cpu"))
    # the benchmark's tree is the program's own layout, leaf for leaf
    assert {p: tuple(t.shape) for p, t in weights.flatten(template).items()} == \
        {p: tuple(t.shape) for p, t in weights.flatten(params).items()}
    assert weights.flatten(params).keys() == weights.flatten(template).keys()
    tokens = torch.randint(0, arch["vocab"], (2, 40), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    loss, _, grads = loss_and_grads(model, params, batch)

    ref = weights.make(pspec, 7, "cpu")
    leaves = {p: t.requires_grad_(True) for p, t in ref.items()}
    ref_loss = ref_model.loss(leaves, batch, arch, ref_model.Precision("fp32"))
    ref_grads = dict(zip(leaves, torch.autograd.grad(ref_loss, list(leaves.values()))))
    assert abs(loss.item() - ref_loss.item()) < 1e-5
    for path, g in weights.flatten(grads).items():
        torch.testing.assert_close(g, ref_grads[path], rtol=1e-4, atol=1e-6, msg=path)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_first_steps_match_the_port_in_fp32(family, tiny_root):
    cell = spec.load_cell(f"tiny-{family}.train.4x64", tiny_root)
    cell.config["options"]["compute_dtype"] = "float32"
    device = torch.device("cpu")
    prog = train_cell.Program(cell, 3, device)
    first = prog.first_steps(cell.traffic["checked_steps"])
    prog.close()
    ref = train_cell.reference_steps(cell, 3, device)
    nums = check.numbers(first, ref)
    assert nums["loss_gap"] < 1e-5 and nums["grad_gap"] < 1e-4 and nums["change_gap"] < 1e-3, nums
