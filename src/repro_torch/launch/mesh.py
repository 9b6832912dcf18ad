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
``"cpu"``; the default process group must already be initialized.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.rank_assign import device_permutation
from repro_torch.core.spread import Placement


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
