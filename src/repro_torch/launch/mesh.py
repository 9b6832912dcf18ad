"""Production mesh construction + Arnold-aligned rank ordering, the
reference's ``launch/mesh.py`` in ``torch.distributed`` terms.

``make_production_mesh`` is a FUNCTION (importing this module never touches
process-group state): single-pod = (16, 16) over (data, model) = 256 ranks;
multi-pod = (2, 16, 16) over (pod, data, model) = 512 ranks.

``make_arnold_mesh`` is the paper's integration point: Arnold's MILP output
(a Placement) is converted to a logical->physical GPU permutation
(core/rank_assign.py) so mesh dimensions -- the process groups collectives
run over -- land on the physical blocks the scheduler aligned.  Rank r is
physical GPU r (contiguous rank blocks = nodes, then minipods), the
counterpart of the reference's device-id order.

Every entry point takes ``device_type="cuda"`` unless the caller asks for
``"cpu"``; the mesh constructors need the default process group, which
:func:`process_group` starts (NCCL on ``cuda``, gloo on ``cpu``) and
:func:`spawn` starts in each of N rank processes.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import socket
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.rank_assign import device_permutation
from repro_torch.core.spread import Placement


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(device_type: str = "cuda", rank: int = 0, world_size: int = 1,
                  port: Optional[int] = None):
    """Start the default process group for ``device_type`` -- NCCL on
    ``cuda`` (rank r on ``cuda:r``), gloo on ``cpu`` -- at
    ``tcp://localhost:<port>`` (a free port for a world of one), and destroy
    it on exit.  Joins an already started group instead, leaving it up."""
    import torch.distributed as dist

    if dist.is_initialized():
        yield
        return
    if device_type == "cuda":
        if torch.cuda.device_count() <= rank:
            raise RuntimeError(f"rank {rank} needs cuda:{rank}, this machine has "
                               f"{torch.cuda.device_count()} visible GPUs")
        torch.cuda.set_device(rank)
    backend = {"cuda": "nccl", "cpu": "gloo"}[device_type]
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port or free_port()}",
                            rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, fn: Callable, world_size: int, port: int, device_type: str,
               args: tuple, out_dir: str) -> None:
    if device_type == "cpu":
        torch.set_num_threads(1)   # N ranks share the host's cores
    with process_group(device_type, rank, world_size, port):
        result = fn(rank, *args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable, world_size: int, device_type: str = "cuda", args: tuple = ()) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes, each with the
    default process group of the world started (:func:`process_group`) and
    destroyed before it returns; ``fn`` must be importable by name.  Returns
    the ranks' return values in rank order; raises if any rank failed.  On
    ``cuda`` it needs ``world_size`` visible GPUs and says so before it starts
    anything."""
    import torch.multiprocessing as mp

    if device_type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks on cuda need {world_size} visible GPUs, this "
                           f"machine has {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_rank_main, args=(fn, world_size, free_port(), device_type, args, out_dir),
                 nprocs=world_size)
        results = []
        for r in range(world_size):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def arnold_rank_grid(
    placement: Placement,
    tp: int,
    shape: tuple,
    ranks: Sequence[int],
    gpus_per_node: int = 8,
) -> np.ndarray:
    """The ranks of an Arnold-ordered mesh as a numpy grid of ``shape``:
    ``ranks[device_permutation(...)]``, ``ranks[g]`` being the rank that
    drives physical GPU ``g``.  Raises when the permutation needs more ranks
    than ``ranks`` holds."""
    perm = device_permutation(placement, tp, gpus_per_node)
    if len(perm) > len(ranks):
        raise ValueError(f"placement needs {len(perm)} devices, have {len(ranks)}")
    return np.asarray(ranks)[perm].reshape(shape)


def make_arnold_mesh(
    placement: Placement,
    tp: int,
    shape: tuple,
    axes: tuple,
    ranks: Optional[Sequence[int]] = None,
    gpus_per_node: int = 8,
    device_type: str = "cuda",
):
    """DeviceMesh whose rank order follows an Arnold placement.

    The permutation orders ranks by logical rank (pp, dp, tp); reshaped
    into ``shape`` (which must multiply to the permutation length), mesh
    dimensions then map onto scheduler-aligned physical blocks.  ``ranks``
    defaults to the world, ``0 .. world_size - 1``.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    grid = arnold_rank_grid(placement, tp, shape, ranks, gpus_per_node)
    return DeviceMesh(device_type, torch.as_tensor(grid), mesh_dim_names=tuple(axes))


def grid_group_spread(grid: np.ndarray, axes: Sequence[str], axis: str,
                      devices_per_pod: int) -> int:
    """Max spread (distinct minipods) over the groups of one axis of a rank
    grid: the groups are the ranks varying along ``axis`` with the others
    fixed, and rank r lies in minipod ``r // devices_per_pod``."""
    pods = np.asarray(grid) // devices_per_pod
    moved = np.moveaxis(pods, list(axes).index(axis), 0)
    flat = moved.reshape(moved.shape[0], -1)
    # one group per column: devices varying along `axis` with others fixed
    spreads = [len(np.unique(flat[:, c])) for c in range(flat.shape[1])]
    return int(max(spreads))


def mesh_device_minipods(mesh, devices_per_pod: int) -> np.ndarray:
    """Minipod id of every rank in the mesh (by rank-block convention)."""
    return mesh.mesh.numpy() // devices_per_pod


def mesh_group_spread(mesh, axis: str, devices_per_pod: int) -> int:
    """Max spread (distinct minipods) over the process groups of one mesh
    dimension -- the mesh-side analogue of Eq. 3, used to verify that Arnold
    ordering actually reduces group spread."""
    return grid_group_spread(mesh.mesh.numpy(), mesh.mesh_dim_names, axis, devices_per_pod)
