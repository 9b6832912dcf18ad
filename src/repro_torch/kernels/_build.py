"""Builds ``kernels/csrc/*.cu`` with ``nvcc`` at first use and loads the
result with ``ctypes``.

Each source has a plain C interface (no PyTorch headers), so a build takes
seconds.  Every source becomes a shared library of its own and all the
``nvcc`` processes are started together, so the build's wall time is that of
the slowest file.  The libraries go into ``build/repro_torch_kernels/<key>/``
at the root of the checkout, where ``<key>`` is a hash of all the sources and
the compiler flags: editing a ``.cu`` file rebuilds.  Nothing is built when
this module is imported; a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}
build_seconds = 0.0  # wall time this process spent in nvcc (0 if cached)
compiler_output: dict[str, str] = {}  # what nvcc printed, by source stem, for this process's builds


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and /usr/local/cuda/bin); "
        "the CUDA kernels of repro_torch are compiled from source at first use"
    )


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_all(extra_flags: tuple[str, ...] = ()) -> Path:
    """Compile every source that has no library yet (one ``nvcc`` each, all
    running at once) and return the directory holding the libraries."""
    global build_seconds
    out_dir = BUILD_ROOT / _key()
    todo = [s for s in sources() if not (out_dir / f"lib{s.stem}.so").exists()]
    if not todo:
        return out_dir
    nvcc = _find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out_dir / f"lib{src.stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
        procs.append((src, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, tmp, cmd, proc in procs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            compiler_output[src.stem] = output
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    build_seconds += time.perf_counter() - t0
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built on first use)."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
    return _libs[name]
