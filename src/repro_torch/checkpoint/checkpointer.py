"""Checkpointing of trees of tensors: one ``.npy`` per leaf + a JSON
manifest, atomic directory rename, optional async save thread, keep-last-N
retention -- the reference's ``checkpoint/checkpointer.py`` for the port.

Tensors are copied from their device to host numpy when ``save`` is called
(bf16 stored as a ``uint16`` view, as the reference stores it, since numpy has
no bf16): leaf by leaf as each is written, or the whole tree before an async
save returns, so training may go on while the async thread writes.  ``restore``
puts every leaf back on the template leaf's device in its dtype.  A Python int
(the optimizer's step counter) is a leaf too.  The trainer's fault
tolerance rests on this: saves are atomic, and ``latest_step`` plus the
deterministic data stream make a restart exact.

A DTensor leaf (a meshed trainer) is gathered leaf by leaf -- each rank of
the process group calls ``save`` and ``restore``, and every rank takes part in
each leaf's gather, a collective -- and rank 0 alone makes the host copy and
writes, once; the others free each gathered leaf at once and wait for the
write at a barrier.  ``restore`` with ``shardings`` cuts each leaf, as it is
read, to this rank's shard of the layout the meshed step holds it in: only
the shard goes to the device.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.parallel.sharding import distribute, full_tensor

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """(key path "a/b/0/c", leaf) pairs, depth first in insertion order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _flatten(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def _unflatten(template, leaves: dict, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, list):
        return [_unflatten(v, leaves, f"{prefix}{i}/") for i, v in enumerate(template)]
    return leaves[prefix.rstrip("/")]


def _world() -> tuple[int, bool]:
    """(this process's rank, whether a process group is up)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), True
    return 0, False


def _barrier() -> None:
    import torch.distributed as dist

    if _world()[1]:
        dist.barrier()


def _to_host(leaf, keep: bool = True) -> tuple[np.ndarray | None, str]:
    """(array, dtype name); the name of a Python int is "int".  A DTensor
    leaf is gathered whole first (every rank must call this for it);
    ``keep=False``: no host copy is made, the array is None."""
    if isinstance(leaf, int):
        return np.asarray(leaf), "int"
    whole = full_tensor(leaf)
    if not keep:
        return None, ""
    t = whole.detach().to("cpu", copy=True)   # a snapshot: training updates in place
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _host_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _from_host(arr: np.ndarray, name: str, template, sharding=None):
    """The leaf on ``template``'s device in its dtype; with a ``sharding``
    this rank's shard of it, cut on the host, as a DTensor."""
    if name == "int":
        return int(arr.item())
    t = _host_tensor(arr, name)
    if sharding is None:
        return t.to(device=template.device, dtype=template.dtype)
    return distribute(t, sharding, device=template.device, dtype=template.dtype)


class Checkpointer:
    def __init__(self, directory, keep_last: int = 3, use_async: bool = False):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.use_async = use_async
        self._pending: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree) -> pathlib.Path:
        """Atomic save.  Each leaf is copied to host memory in turn and
        written before the next is copied, so the host holds one leaf at a
        time; with use_async=True the whole tree is copied first (a snapshot:
        training goes on and updates it in place), ``save`` returns, and a
        thread writes it."""
        rank, grouped = _world()
        host = ((k, *_to_host(v, keep=rank == 0)) for k, v in _flatten(tree))
        if self.use_async:
            host = list(host)
            self.wait()
            if rank == 0:
                self._pending = threading.Thread(target=self._write, args=(step, host),
                                                 daemon=True)
                self._pending.start()
        else:
            if rank == 0:
                self._write(step, host)
            else:   # every rank takes part in each leaf's gather
                for _ in host:
                    pass
            _barrier()
        return self.dir / f"step_{step}"

    def _write(self, step: int, host_items):
        tmp = self.dir / f".tmp_step_{step}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {}
        for i, (key, arr, dtype_name) in enumerate(host_items):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest[key] = {"file": fname, "shape": list(arr.shape), "dtype": dtype_name}
        (tmp / "manifest.json").write_text(json.dumps({"step": step, "leaves": manifest}))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic on POSIX
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self.use_async:
            _barrier()

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            m = _STEP_RE.match(p.name)
            if m and (p / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, shardings=None):
        """Restore into the structure of ``template`` (a tree of tensors and
        ints) as new tensors; each goes to its template leaf's device and
        dtype.  Only a leaf's shape, dtype and device are read, so fake
        tensors with no storage make a template.  ``shardings``: a tree of
        ``parallel.sharding.NamedSharding`` (None for a leaf kept whole)
        matching ``template``; each leaf is then distributed by it."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())["leaves"]
        layouts = dict(_flatten(shardings)) if shardings is not None else {}
        leaves = {}
        for key, tmpl in _flatten(template):
            if key not in manifest:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            entry = manifest[key]
            arr = np.load(path / entry["file"])
            shape = tuple(tmpl.shape) if isinstance(tmpl, torch.Tensor) else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: ckpt shape {arr.shape} != template {shape}")
            leaves[key] = _from_host(arr, entry["dtype"], tmpl, layouts.get(key))
        return _unflatten(template, leaves)
