"""At a cell's own size on a CUDA device (skipped elsewhere): the program's
first steps pass the cell's limits, and the control, the reference in fp8 put
in the program's place, fails them.

    PYTHONPATH=src python -m pytest -q gpubench/tests/test_card.py
"""

from __future__ import annotations

import pytest

from gpubench.tests.tiny import REPO
from gpubench import check, spec, train_cell

CELLS = ["phi4-mini.train.4x1024"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes_and_the_control_fails(name, cuda_device):
    from repro_torch.kernels import _build

    _build.build_all()
    cell = spec.load_cell(name, REPO)
    seed = 3_900_000_001
    prog = train_cell.Program(cell, seed, cuda_device)
    first = prog.first_steps(cell.traffic["checked_steps"])
    prog.close()
    del prog
    train_cell.free(cuda_device)
    ref = train_cell.reference_steps(cell, seed, cuda_device)
    assert check.judge(check.numbers(first, ref), cell.limits)
    control = train_cell.reference_steps(cell, seed, cuda_device, "fp8")
    assert not check.judge(check.numbers(control, ref), cell.limits)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_a_dropped_gradient_fails_at_the_cell_s_size(name, cuda_device):
    """The program's backward with the first layer's smallest leaf's gradient
    dropped (a norm's scale): the cell's limits catch it."""
    from gpubench.tests.test_planted_faults import gradient_zero
    from repro_torch.kernels import _build

    _build.build_all()
    cell = spec.load_cell(name, REPO)
    seed = 3_900_000_017
    prog = train_cell.Program(cell, seed, cuda_device)
    gradient_zero(prog)
    first = prog.first_steps(cell.traffic["checked_steps"])
    prog.close()
    del prog
    train_cell.free(cuda_device)
    nums, about = check.compare(first, train_cell.reference_steps(cell, seed, cuda_device))
    print(name, nums, about)
    assert not check.judge(nums, cell.limits)
