"""A whole run of a tiny cell on the CPU (the harness's look for a card
skipped), once sound and once with the timed path broken underneath: each
fault a training cell can have must turn ``correct`` false.  The control, the
reference in fp8 put in the program's place, must fail the limits too."""

from __future__ import annotations

import json

import pytest
import torch

from gpubench import check, spec, train_cell, weights


def run_cell(root, cell, capsys, wrap_step=None, trace=0, seed=11) -> dict:
    from gpubench import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace)],
                  device=torch.device("cpu"), wrap_step=wrap_step, root=root)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def state_unchanged(prog):
    inner = prog.step_fn

    def step(params, opt_state, batch):
        saved = [t.detach().clone() for t in weights.flatten(params).values()]
        params, opt_state, metrics = inner(params, opt_state, batch)
        with torch.no_grad():
            for t, s in zip(weights.flatten(params).values(), saved):
                t.copy_(s)
        return params, opt_state, metrics
    prog.step_fn = step


def half_batch(prog):
    inner = prog.step_fn
    prog.step_fn = lambda p, o, batch: inner(p, o, {k: v[: v.shape[0] // 2] for k, v in batch.items()})


def leaf_unmoved(prog):
    from gpubench.reference.train import unmoved_leaf

    inner = prog.step_fn

    def step(params, opt_state, batch):
        flat = weights.flatten(params)
        leaf = flat[unmoved_leaf(flat)]
        saved = leaf.detach().clone()
        params, opt_state, metrics = inner(params, opt_state, batch)
        with torch.no_grad():
            leaf.copy_(saved)
        return params, opt_state, metrics
    prog.step_fn = step


def gradient_zero(prog):
    """The backward drops one small leaf's gradient (the first layer's
    smallest: a norm's scale, a Mamba2 head's ``A_log``)."""
    import repro_torch.train.train_step as ts
    from gpubench.reference.train import zeroed_leaf

    inner, real = prog.step_fn, ts.loss_and_grads

    def zeroing(*args, **kwargs):
        loss, metrics, grads = real(*args, **kwargs)
        flat = weights.flatten(grads)
        flat[zeroed_leaf(flat)].zero_()
        return loss, metrics, grads

    def step(*args):
        ts.loss_and_grads = zeroing
        try:
            return inner(*args)
        finally:
            ts.loss_and_grads = real
    prog.step_fn = step


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_a_sound_run_is_correct(family, tiny_root, capsys):
    line = run_cell(tiny_root, f"tiny-{family}.train.4x64", capsys)
    assert line["correct"], line["check"]
    assert list(line)[-1] == "check" and line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["metrics"]) >= {"tokens_per_s", "setup_s"}


# A Mamba2 layer's smallest leaves (A_log, D, dt_bias: one number a head) are
# too small for a dropped gradient to show against the median leaf's change:
# that fault is the dense family's here (PERF.md, Open questions).
@pytest.mark.parametrize("family, fault", [
    (family, fault) for family in ("dense", "hybrid")
    for fault in (state_unchanged, half_batch, leaf_unmoved, gradient_zero)
    if (family, fault) != ("hybrid", gradient_zero)])
def test_a_broken_step_is_not_correct(family, fault, tiny_root, capsys):
    line = run_cell(tiny_root, f"tiny-{family}.train.4x64", capsys, wrap_step=fault)
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_the_fp8_control_fails_the_limits(family, tiny_root):
    cell = spec.load_cell(f"tiny-{family}.train.4x64", tiny_root)
    cpu = torch.device("cpu")
    nums = check.numbers(train_cell.reference_steps(cell, 5, cpu, "fp8"),
                         train_cell.reference_steps(cell, 5, cpu))
    print(family, "control", nums)
    assert not check.judge(nums, cell.limits), nums
