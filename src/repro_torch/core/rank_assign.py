"""Logical-rank to physical-device mapping (paper §6: "modify [the training
framework] to ensure that communication groups follow the placement").

Arnold's output is consumed by the training framework as a permutation:
logical rank ``(pp_stage, dp_rank, tp_rank)`` -> physical GPU.  In the port
this permutation orders the ranks of a ``torch.distributed`` ``DeviceMesh``
(rank r is physical GPU r), so the mesh's process groups (mesh dimensions)
land on the aligned physical blocks the MIP chose (see
``repro_torch.launch.mesh``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.spread import Placement
from repro_torch.core.topology import GPUS_PER_NODE


def node_rank_order(placement: Placement) -> list[int]:
    """Node ids ordered by matrix rank (row-major: PP-inner, like Megatron's
    default order with pipeline innermost across nodes)."""
    return [int(n) for n in placement.assignment.ravel()]


def logical_to_physical_gpus(
    placement: Placement, tp: int, gpus_per_node: int = GPUS_PER_NODE
) -> np.ndarray:
    """Array ``phys[pp, dp, tp]`` of physical GPU ids.

    Matrix cell (r, c) hosts ``gpus_per_node // tp`` DP replicas of PP stage
    ``c``; within a node, TP ranks map to consecutive local GPUs (TP stays on
    NVLink/intra-node links, §2).
    """
    n_rows, n_cols = placement.comm.shape
    reps = gpus_per_node // tp  # DP replicas per node
    dp = n_rows * reps
    out = np.empty((n_cols, dp, tp), dtype=int)
    for r in range(n_rows):
        for c in range(n_cols):
            node = int(placement.assignment[r, c])
            base = node * gpus_per_node
            for k in range(reps):
                for t in range(tp):
                    out[c, r * reps + k, t] = base + k * tp + t
    return out


def device_permutation(
    placement: Placement, tp: int, gpus_per_node: int = GPUS_PER_NODE
) -> list[int]:
    """Flat physical-GPU permutation in logical order (pp, dp, tp) -- feed to
    ``ranks[perm]``-style mesh constructors
    (:func:`repro_torch.launch.mesh.make_arnold_mesh`)."""
    return [int(g) for g in logical_to_physical_gpus(placement, tp, gpus_per_node).ravel()]
