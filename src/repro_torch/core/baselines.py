"""Baseline scheduling algorithms benchmarked against Arnold (paper §7.1).

1. ``best_fit``    -- assigns nodes to the minipods with the least remaining
                      resources (classic VM-consolidation best-fit [32]).
2. ``random_fit``  -- balanced random assignment across minipods [44].
3. ``gpu_packing`` -- SOTA GPU-cluster packing [43, 45], modified (as in the
                      paper) to pack multi-GPU jobs into as few minipods as
                      possible (largest-free-first consolidation).
4. ``topo_aware``  -- topology-aware placement [2]: hierarchical static
                      mapping by dual recursive bi-partitioning [10], with
                      the graph bi-partitioning done by the
                      Fiduccia-Mattheyses linear-time heuristic [11].

Each baseline returns a :class:`Placement` so all algorithms are scored by
the same Eq. 2 weighted-spread metric.

The public functions here are **deprecated** thin shims over the unified
scheduler registry (:mod:`repro_torch.core.scheduler`); the ``_``-prefixed
implementations are what the registry wraps.  Use
``get_scheduler(name).schedule(request)`` -- the only supported entry point
(DESIGN.md §2.4) -- which adds excluded/reserved-node masking and a uniform
result type; the shims emit :class:`DeprecationWarning` on every call.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.comm_matrix import CommMatrix
from repro_torch.core.mip import Infeasible
from repro_torch.core.spread import Placement
from repro_torch.core.topology import Cluster


def _materialize(comm: CommMatrix, cluster: Cluster, node_order: list[int]) -> Placement:
    """Assign matrix cells (row-major rank order) to an ordered node list."""
    if len(node_order) != comm.n_cells:
        raise Infeasible(
            f"need {comm.n_cells} nodes, got {len(node_order)}"
        )
    assignment = np.array(node_order, dtype=int).reshape(comm.shape)
    return Placement(comm=comm, assignment=assignment, cluster=cluster)


def _take_from_pods(cluster: Cluster, pod_order: list[int], n: int) -> list[int]:
    out: list[int] = []
    for j in pod_order:
        if len(out) >= n:
            break
        out.extend(cluster.free_in_domain(j)[: n - len(out)])
    if len(out) < n:
        raise Infeasible(f"cluster has only {len(out)} free nodes, need {n}")
    return out


# ---------------------------------------------------------------------------
def _best_fit(comm: CommMatrix, cluster: Cluster) -> Placement:
    """Fill domains with the *least* remaining free nodes first."""
    free = cluster.free_capacities()
    pods = sorted(
        (j for j in range(cluster.n_domains) if free[j] > 0),
        key=lambda j: (free[j], j),
    )
    return _materialize(comm, cluster, _take_from_pods(cluster, pods, comm.n_cells))


def _gpu_packing(comm: CommMatrix, cluster: Cluster) -> Placement:
    """Consolidate the job into the fewest domains (largest-free-first)."""
    free = cluster.free_capacities()
    pods = sorted(
        (j for j in range(cluster.n_domains) if free[j] > 0),
        key=lambda j: (-free[j], j),
    )
    return _materialize(comm, cluster, _take_from_pods(cluster, pods, comm.n_cells))


def _random_fit(comm: CommMatrix, cluster: Cluster, rng: np.random.Generator) -> Placement:
    """Balanced random assignment: nodes drawn round-robin from domains in
    random order, so the load lands evenly (fair) but topology-blind."""
    free_lists = {
        j: list(rng.permutation(cluster.free_in_domain(j)))
        for j in range(cluster.n_domains)
        if cluster.free_in_domain(j)
    }
    order: list[int] = []
    pods = list(free_lists)
    while len(order) < comm.n_cells and pods:
        pods = [j for j in pods if free_lists[j]]
        if not pods:
            break
        for j in rng.permutation(pods):
            if len(order) >= comm.n_cells:
                break
            if free_lists[j]:
                order.append(int(free_lists[j].pop()))
    return _materialize(comm, cluster, order)


# ---------------------------------------------------------------------------
# Topo-aware: dual recursive bi-partitioning with Fiduccia-Mattheyses.
# ---------------------------------------------------------------------------

def _job_graph(comm: CommMatrix) -> dict[int, dict[int, float]]:
    """Weighted adjacency of matrix cells.

    PP groups are chains (send-recv to adjacent stages, weight v_p); DP
    groups are rings (ring all-gather/reduce-scatter between consecutive
    replicas, weight v_d).  Matches the paper's job-graph analogy to the
    communication matrix.
    """
    n_rows, n_cols = comm.shape
    ids = comm.cell_ids()
    adj: dict[int, dict[int, float]] = {int(i): {} for i in ids.ravel()}

    def link(a: int, b: int, w: float):
        adj[a][b] = adj[a].get(b, 0.0) + w
        adj[b][a] = adj[b].get(a, 0.0) + w

    for r in range(n_rows):
        for c in range(n_cols - 1):
            link(int(ids[r, c]), int(ids[r, c + 1]), comm.v_p)
    for c in range(n_cols):
        for r in range(n_rows):
            link(int(ids[r, c]), int(ids[(r + 1) % n_rows, c]), comm.v_d / max(n_rows, 1))
    return adj


def _fm_bipartition(
    adj: dict[int, dict[int, float]],
    vertices: list[int],
    size_a: int,
    seed: int = 0,
    passes: int = 4,
) -> tuple[list[int], list[int]]:
    """Fiduccia-Mattheyses min-cut bi-partition into parts of exact sizes
    (size_a, len(vertices)-size_a).

    Pair-swap FM variant (keeps both part sizes fixed, since minipod
    capacities are hard constraints): each pass greedily performs the
    best-gain swap of one unlocked vertex from each side, locks both, and at
    the end of the pass rolls back to the best cumulative-gain prefix.
    """
    del seed  # deterministic initial split; randomness not needed
    verts = list(vertices)
    side = {v: (i >= size_a) for i, v in enumerate(verts)}  # False=A, True=B

    def gain(v: int, cur: dict[int, bool]) -> float:
        # Gain of moving v to the other side: external - internal edge weight.
        g = 0.0
        for u, w in adj[v].items():
            if u in cur:
                g += w if cur[u] != cur[v] else -w
        return g

    for _ in range(passes):
        locked: set[int] = set()
        cur = dict(side)
        history: list[tuple[float, int, int]] = []  # (cum_gain, va, vb)
        cum = 0.0
        while True:
            part_a = [v for v in verts if not cur[v] and v not in locked]
            part_b = [v for v in verts if cur[v] and v not in locked]
            if not part_a or not part_b:
                break
            ga = {v: gain(v, cur) for v in part_a}
            gb = {v: gain(v, cur) for v in part_b}
            va = max(part_a, key=lambda v: (ga[v], -v))
            vb = max(part_b, key=lambda v: (gb[v], -v))
            cum += ga[va] + gb[vb] - 2 * adj[va].get(vb, 0.0)
            cur[va], cur[vb] = True, False
            locked.update((va, vb))
            history.append((cum, va, vb))
        if not history:
            break
        gains = [h[0] for h in history]
        best_i = int(np.argmax(gains))
        if gains[best_i] <= 1e-9:
            break  # no improving prefix; partition converged
        for _, va, vb in history[: best_i + 1]:
            side[va], side[vb] = True, False
    part_a = [v for v in verts if not side[v]]
    part_b = [v for v in verts if side[v]]
    assert len(part_a) == size_a, (len(part_a), size_a)
    return part_a, part_b


def _topo_aware(comm: CommMatrix, cluster: Cluster) -> Placement:
    """Hierarchical static mapping: recursively bi-partition the physical
    graph (fabric domains, by free capacity) and map the job graph onto the
    two halves with an FM min-cut of matching sizes [2, 10, 11].

    The physical split delegates to the fabric's bisection structure
    (:meth:`Cluster.partition_domains`): id-order halves on ``clos``
    (identical to the pre-fabric behaviour), axis-aligned slabs on
    ``torus``, group-coherent halves on ``dragonfly``."""
    adj = _job_graph(comm)
    free = cluster.free_capacities()
    pods = [j for j in range(cluster.n_domains) if free[j] > 0]
    if sum(free[j] for j in pods) < comm.n_cells:
        raise Infeasible("not enough free nodes")

    cell_to_pod: dict[int, int] = {}

    def recurse(pod_set: list[int], cells: list[int]):
        if not cells:
            return
        if len(pod_set) == 1:
            for v in cells:
                cell_to_pod[v] = pod_set[0]
            return
        pods_a, pods_b = cluster.partition_domains(pod_set)
        cap_a = sum(free[j] for j in pods_a)
        size_a = min(cap_a, len(cells))
        # ensure part B fits too
        cap_b = sum(free[j] for j in pods_b)
        size_a = max(size_a, len(cells) - cap_b)
        part_a, part_b = _fm_bipartition(adj, cells, size_a)
        recurse(pods_a, part_a)
        recurse(pods_b, part_b)

    recurse(pods, [int(v) for v in comm.cell_ids().ravel()])

    # materialize: rank-contiguous node assignment inside each pod
    n_rows, n_cols = comm.shape
    assignment = np.full((n_rows, n_cols), -1, dtype=int)
    for j in pods:
        cells = sorted(v for v, p in cell_to_pod.items() if p == j)
        nodes = cluster.free_in_domain(j)
        for v, nid in zip(cells, nodes):
            assignment[v // n_cols, v % n_cols] = nid
    return Placement(comm=comm, assignment=assignment, cluster=cluster)


# ---------------------------------------------------------------------------
# Public entry points: deprecated thin shims over the scheduler registry.
# The registry (get_scheduler, DESIGN.md §2.4) is the only supported entry
# point; these remain for backward compatibility and warn on every call.
# ---------------------------------------------------------------------------

def _via_registry(name: str, comm: CommMatrix, cluster: Cluster, **req_kw) -> Placement:
    import warnings

    from repro_torch.core.scheduler import ScheduleRequest, get_scheduler

    warnings.warn(
        f"the module-level baseline functions are deprecated; use "
        f'get_scheduler("{name}").schedule(ScheduleRequest(...)) instead',
        DeprecationWarning,
        stacklevel=3,
    )
    request = ScheduleRequest(comm=comm, cluster=cluster, **req_kw)
    return get_scheduler(name).schedule(request).placement


def best_fit(comm: CommMatrix, cluster: Cluster) -> Placement:
    """Deprecated shim for ``get_scheduler("best-fit")``; see
    :func:`_best_fit` for the algorithm."""
    return _via_registry("best-fit", comm, cluster)


def gpu_packing(comm: CommMatrix, cluster: Cluster) -> Placement:
    """Deprecated shim for ``get_scheduler("gpu-packing")``; see
    :func:`_gpu_packing` for the algorithm."""
    return _via_registry("gpu-packing", comm, cluster)


def random_fit(
    comm: CommMatrix,
    cluster: Cluster,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> Placement:
    """Deprecated shim for ``get_scheduler("random-fit")``; reproducible via
    ``seed`` or an explicit ``rng`` (``rng`` wins when both are given)."""
    return _via_registry("random-fit", comm, cluster, seed=seed, rng=rng)


def topo_aware(comm: CommMatrix, cluster: Cluster, seed: int = 0) -> Placement:
    """Deprecated shim for ``get_scheduler("topo-aware")``; ``seed`` is
    accepted for API compatibility but the FM partitioning is deterministic."""
    del seed
    return _via_registry("topo-aware", comm, cluster)


ALL_BASELINES = {
    "best-fit": best_fit,
    "random-fit": random_fit,
    "gpu-packing": gpu_packing,
    "topo-aware": topo_aware,
}
