"""Spread metric and scheduling objective (paper §5.2, Eq. 2-3), fabric-generic.

The *spread* of a communication group is the number of locality domains
its members straddle (minipods on the paper's CLOS fabric), derived from
the discrete distance over one-hot placement vectors (Eq. 3): position
``i`` contributes 1 iff two members disagree there, so a group inside one
domain has distance 0, and a group spanning ``q > 1`` domains has distance
``q``.  The scheduling objective (Eq. 2) is the weighted sum of the
*maximum* spread over DP groups (weight alpha) and PP groups (weight
beta) -- max, because the slowest group stragglers the synchronous step.

On fabrics with graded locality (torus, dragonfly) the domain count alone
under-describes a placement, so :func:`max_hop_diameters` additionally
reports each axis's worst *hop diameter* -- the max pairwise fabric
distance among the domains a group touches -- which is what the
per-fabric network models consume (DESIGN.md §9.3).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.comm_matrix import CommMatrix
from repro_torch.core.topology import Cluster


@dataclasses.dataclass
class Placement:
    """A complete placement of a communication matrix onto a cluster.

    ``assignment[r, c]`` is the node id hosting matrix cell (r, c); rows are
    PP groups, columns are DP groups.
    """

    comm: CommMatrix
    assignment: np.ndarray  # (n_rows, n_cols) of node ids
    cluster: Cluster

    def __post_init__(self):
        a = np.asarray(self.assignment)
        if a.shape != self.comm.shape:
            raise ValueError(f"assignment shape {a.shape} != matrix {self.comm.shape}")
        if len(np.unique(a)) != a.size:
            raise ValueError("assignment maps two cells to the same node")
        self.assignment = a

    def domain_of(self) -> np.ndarray:
        """Fabric domain id per cell, same shape as the matrix.

        One fancy-indexing gather through the cluster's precomputed
        node->domain array -- this is on the hot path of every spread
        evaluation (it used to be a per-cell ``np.vectorize`` Python
        lookup)."""
        return self.cluster.domain_index[self.assignment]

    def minipod_of(self) -> np.ndarray:
        """Historical ``clos`` name for :meth:`domain_of`; identical output
        on every fabric (minipods are the clos fabric's domains)."""
        return self.domain_of()

    def node_ids(self) -> list[int]:
        return [int(n) for n in self.assignment.ravel()]


def distance_onehot(vectors: np.ndarray) -> int:
    """Eq. 3, literally: ``vectors`` is (n_members, k) one-hot rows.

    D = |{i : exists j != l with v_j[i] != v_l[i]}|.
    """
    v = np.asarray(vectors)
    if v.ndim != 2:
        raise ValueError("expected (n, k) one-hot matrix")
    differs = np.any(v != v[0], axis=0)  # column differs from first member
    return int(np.count_nonzero(differs))


def group_spread(domains: np.ndarray, k: int | None = None) -> int:
    """Spread of one group given integer domain assignments.

    Equivalent to ``distance_onehot`` on the one-hot encoding: 0 when all
    members share a domain, else the number of distinct domains.
    """
    u = np.unique(np.asarray(domains))
    return 0 if len(u) <= 1 else int(len(u))


def group_hop_diameter(domains: np.ndarray, cluster: Cluster) -> int:
    """Worst pairwise fabric hop distance among the domains of one group
    (0 when the group sits in a single domain)."""
    u = np.unique(np.asarray(domains))
    if len(u) <= 1:
        return 0
    return max(
        cluster.domain_distance(int(a), int(b))
        for i, a in enumerate(u)
        for b in u[i + 1:]
    )


def max_spreads(placement: Placement) -> tuple[int, int]:
    """(max DP-group spread, max PP-group spread) of a placement."""
    pods = placement.domain_of()
    pp_spread = max(group_spread(pods[r, :]) for r in range(pods.shape[0]))
    dp_spread = max(group_spread(pods[:, c]) for c in range(pods.shape[1]))
    return dp_spread, pp_spread


def max_hop_diameters(placement: Placement) -> tuple[int, int]:
    """(max DP-group hop diameter, max PP-group hop diameter).

    On ``clos`` every multi-domain group has the same diameter (all
    minipods are equidistant through the core); on torus/dragonfly this is
    the locality signal the per-fabric network models run on.
    """
    pods = placement.domain_of()
    cluster = placement.cluster
    pp = max(group_hop_diameter(pods[r, :], cluster) for r in range(pods.shape[0]))
    dp = max(group_hop_diameter(pods[:, c], cluster) for c in range(pods.shape[1]))
    return dp, pp


def weighted_spread(placement: Placement, alpha: float, beta: float | None = None) -> float:
    """Eq. 2: alpha * max_j D(DP group j) + beta * max_i D(PP group i).

    ``alpha`` is the DP affinity, ``beta`` the PP affinity; ``alpha+beta=1``.
    This is the metric used to benchmark scheduling algorithms (§7.1).
    """
    if beta is None:
        beta = 1.0 - alpha
    if not np.isclose(alpha + beta, 1.0):
        raise ValueError(f"alpha+beta must be 1, got {alpha}+{beta}")
    dp_s, pp_s = max_spreads(placement)
    return alpha * dp_s + beta * pp_s


def mean_spreads(placement: Placement) -> tuple[float, float]:
    """Average (not max) spreads -- reported alongside the paper metric."""
    pods = placement.domain_of()
    pp = float(np.mean([group_spread(pods[r, :]) for r in range(pods.shape[0])]))
    dp = float(np.mean([group_spread(pods[:, c]) for c in range(pods.shape[1])]))
    return dp, pp
