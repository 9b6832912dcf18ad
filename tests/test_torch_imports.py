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
            "trainer.py", "checkpointer.py", "pipeline.py", "mip.py", "hierarchical.py",
            "scheduler.py", "fabric.py", "placement.py", "mesh.py", "netmodel.py", "queue.py",
            "simulator.py", "repair.py", "driver.py", "xlstm.py", "whisper.py", "sharding.py",
            "collectives.py", "roofline.py", "dryrun.py", "perf.py", "model_zoo.py"} <= names
    launch = {p.name for p in PORT_FILES if p.parent.name == "launch"}
    assert launch == {"__init__.py", "mesh.py", "train.py", "roofline.py", "dryrun.py", "perf.py"}
    parallel = {p.name for p in PORT_FILES if p.parent.name == "parallel"}
    assert parallel == {"__init__.py", "sharding.py", "collectives.py", "pipeline.py"}


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
        "class Blocked:  # as if jax, the reference and triton were not installed\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro', 'triton'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Blocked())\n"
        "import repro_torch, repro_torch.serve, repro_torch.models, repro_torch.convert\n"
        "import repro_torch.kernels.ops, repro_torch.train, repro_torch.launch.train\n"
        "import repro_torch.core, repro_torch.topo, repro_torch.launch.mesh\n"
        "import repro_torch.launch.roofline, repro_torch.launch.dryrun, repro_torch.launch.perf\n"
        "import repro_torch.parallel.collectives, repro_torch.parallel.pipeline\n"
        "from repro_torch.serve import place_replicas\n"
        "import warnings; warnings.simplefilter('ignore', DeprecationWarning)\n"
        "from repro_torch import core as c\n"
        "m = c.ModelSpec(name='m', hidden=64, layers=2, vocab=100, seq_len=8, global_batch=8)\n"
        "comm = c.build_comm_matrix(c.JobSpec(n_gpus=32, tp=8, pp=2, model=m))\n"
        "cl = c.Cluster.uniform(2, 4)\n"
        "c.schedule_mip(comm, cl, alpha=0.5); c.best_fit(comm, cl)  # their lazy imports\n"
        "c.HierarchicalScheduler().schedule(c.ScheduleRequest(comm=comm, cluster=cl))\n"
        "import repro_torch.faults as f\n"
        "lpj = c.build_comm_matrix(c.JobSpec(n_gpus=64, tp=8, pp=2, model=m))\n"
        "jobs = c.poisson_trace(20, 1800.0, 3600.0, 4, seed=5)\n"
        "sim = c.TraceSimulator(c.QueuePolicy(c.Cluster.uniform(4, 8),\n"
        "                                     scheduler='hier,mip,topo-aware'))\n"
        "res = sim.run(jobs, t_end=86400.0, lpj_plan=(lpj, 1800.0, 0.5, 'pp'),\n"
        "              faults=f.FaultModel(seed=3, node_mtbf_s=5 * 86400.0))  # lazy imports\n"
        "assert res.goodput is not None and res.n_faults > 0\n"
        "cl2 = c.Cluster.uniform(4, 8)\n"
        "placed = c.get_scheduler('topo-aware').schedule(c.ScheduleRequest(comm=lpj, cluster=cl2))\n"
        "cl2.allocate(placed.placement.node_ids())\n"
        "fm = c.FailureManager(placed.placement, cl2, backup_frac=0.1)\n"
        "fm.on_failure(placed.placement.node_ids()[0])\n"
        "c.characterize(c.JobSpec(n_gpus=64, tp=8, pp=2, model=m), lambda: c.Cluster.uniform(4, 8))\n"
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


def test_core_and_faults_export_what_the_reference_exports():
    import repro.core
    import repro.faults
    import repro_torch.core
    import repro_torch.faults

    assert sorted(repro_torch.core.__all__) == sorted(repro.core.__all__)
    assert repro_torch.faults.__all__ == repro.faults.__all__
    assert repro_torch.faults.TIERS == repro.faults.TIERS
    for name in set(repro_torch.faults.__all__) - {"TIERS"}:
        assert getattr(repro_torch.faults, name).__module__.startswith("repro_torch.faults.")
