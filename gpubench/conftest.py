"""Tests of the benchmark (``tests/``), on the CPU at tiny sizes (the kernels'
plain route); those marked ``card`` need a CUDA device and skip elsewhere.

    PYTHONPATH=src python -m pytest -q gpubench/tests
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
for path in (str(REPO), str(REPO / "src")):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips elsewhere)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    from gpubench.tests.tiny import make_root

    return make_root(tmp_path)
