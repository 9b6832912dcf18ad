"""The port stands alone: nothing under ``src/repro_torch/`` nor
``chip_smoke.py`` imports ``jax`` or the ``repro`` package, and importing the
port needs neither a CUDA compiler nor ``triton``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro", "triton"}


def imported_roots(path: Path) -> set[str]:
    """Top-level package names a file imports anywhere (function bodies too)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"ops.py", "layers.py", "transformer.py", "engine.py", "chip_smoke.py", "adamw.py",
            "trainer.py", "checkpointer.py", "pipeline.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_file_imports_neither_jax_nor_the_reference(path):
    assert not (imported_roots(path) & FORBIDDEN), f"{path} imports {imported_roots(path) & FORBIDDEN}"


def test_cuda_sources_have_a_plain_c_interface():
    """No PyTorch headers in the kernels: they build in seconds with nvcc alone."""
    sources = sorted((ROOT / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu"))
    assert {s.name for s in sources} == {"rmsnorm.cu", "flash_attention.cu", "ssd_chunk.cu",
                                         "ssd_chunk_bwd.cu"}
    for src in sources:
        text = src.read_text()
        assert "torch/" not in text and "ATen" not in text
        assert 'extern "C"' in text


def test_importing_the_port_loads_neither_jax_nor_the_reference():
    code = (
        "import sys, shutil\n"
        "import repro_torch, repro_torch.serve, repro_torch.models, repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.train, repro_torch.launch.train\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'))\n"
        "assert not bad, bad\n"
        "import repro_torch.kernels._build as b\n"
        "assert b.build_seconds == 0.0 and not b._libs, 'nothing is built at import'\n"
        "print('clean')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
