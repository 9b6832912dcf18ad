"""Arnold's MILP scheduling algorithm (paper §5.2, Eq. 4-10).

The exact objective (Eq. 2) has a discrete distance term that off-the-shelf
solvers handle poorly, so the paper coarsens the scheduling unit to a whole
communication group (groups are homogeneous and gang-synchronous) and solves
the bin-packing-like MILP

    MIN   alpha * sum_j y_j + beta * T
    s.t.  forall i: sum_j s_ij <= T                (max spread)
          forall j: sum_i p_ij <= c_j * y_j        (capacity)
          forall i: sum_j p_ij  = 1                (allocation)
          forall i,j: p_ij <= s_ij                 (minipod selection)
          y_j, s_ij in {0,1},  p_ij in [0,1]

with ``i`` ranging over scheduling-unit groups (rows = PP groups by default,
Table 1) and ``j`` over minipods; ``c_j`` is the minipod's free capacity
normalized by the group size.  We solve with scipy's HiGHS MILP (the paper
uses SCIP [4]); ``integral_nodes=True`` additionally makes the node counts
``n_ij = p_ij * group_size`` integral, which removes the rounding repair the
continuous (paper-faithful) relaxation needs.

After solving, nodes inside each minipod are assigned **contiguous rank
indices** (§5.2 last paragraph) so that intra-minipod communication also
stays rack-local.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from repro_torch.core.comm_matrix import CommMatrix
from repro_torch.core.spread import Placement
from repro_torch.core.topology import Cluster


@dataclasses.dataclass
class MipResult:
    placement: Placement
    objective: float
    n_pods_used: int
    max_unit_spread: int
    solve_seconds: float
    counts: np.ndarray  # (n_groups, n_minipods) node counts
    method: str = "milp"  # "milp" | "greedy-proven-optimal" | "greedy-incumbent"


class Infeasible(RuntimeError):
    pass


@contextlib.contextmanager
def _silence_stdout():
    """HiGHS prints C-level diagnostics scipy cannot suppress; mute fd 1+2."""
    saved = [os.dup(1), os.dup(2)]
    try:
        devnull = os.open(os.devnull, os.O_WRONLY)
        os.dup2(devnull, 1)
        os.dup2(devnull, 2)
        os.close(devnull)
        yield
    finally:
        os.dup2(saved[0], 1)
        os.dup2(saved[1], 2)
        os.close(saved[0])
        os.close(saved[1])


# ---------------------------------------------------------------------------
# Greedy bounding: the scheduling-unit groups are *identical* (homogeneous +
# gang-synchronous, §5.2), which creates heavy symmetry in the MILP.  Before
# invoking the solver we compute (a) a provable lower bound on the objective
# and (b) greedy candidate solutions; when a candidate meets the bound the
# MILP is skipped entirely, otherwise the candidate caps the solver's work
# as an incumbent compared against the time-limited MILP result.
# ---------------------------------------------------------------------------

def _objective_lower_bound(group_size: int, m: int, free: np.ndarray, alpha: float, beta: float) -> float:
    """Provable objective lower bound, split by the max-spread value T:

    * T = 1: every group whole -> pods provide ``floor(c_j/G)`` slots, and the
      minimum pod count q1 takes pods with the most slots (exact).
    * T >= 2: pods only need raw capacity -> q_min pods by capacity.

    The bound is the smaller branch; T >= 3 is dominated by the T = 2 branch.
    """
    caps = np.sort(free)[::-1]
    need = group_size * m
    q_min = int(np.searchsorted(np.cumsum(caps), need) + 1)
    slots = np.sort(free // group_size)[::-1]
    cum_slots = np.cumsum(slots)
    if cum_slots[-1] >= m:
        q1 = int(np.searchsorted(cum_slots, m) + 1)
        lb_t1 = alpha * max(q1, q_min) + beta * 1.0
    else:
        lb_t1 = np.inf  # T=1 infeasible
    lb_t2 = alpha * q_min + beta * 2.0
    return float(min(lb_t1, lb_t2))


def _greedy_whole(group_size: int, m: int, free: np.ndarray) -> np.ndarray | None:
    """T=1 candidate: pack whole groups into pods with the most slots."""
    slots = (free // group_size).astype(int)
    order = np.argsort(-slots)
    counts = np.zeros((m, len(free)), dtype=int)
    g = 0
    for j in order:
        for _ in range(int(slots[j])):
            if g >= m:
                return counts
            counts[g, j] = group_size
            g += 1
    return None  # not enough whole-group slots for T=1


def _greedy_sequential(group_size: int, m: int, free: np.ndarray, n_pods: int) -> np.ndarray | None:
    """Contiguous fill of the ``n_pods`` largest pods (descending capacity);
    groups may straddle pod boundaries (spread > 1 at the seams)."""
    order = np.argsort(-free)[:n_pods]
    if free[order].sum() < group_size * m:
        return None
    counts = np.zeros((m, len(free)), dtype=int)
    g, need = 0, group_size
    for j in order:
        avail = int(free[j])
        while avail > 0 and g < m:
            take = min(avail, need)
            counts[g, j] += take
            avail -= take
            need -= take
            if need == 0:
                g, need = g + 1, group_size
    return counts if g >= m else None


def _counts_objective(counts: np.ndarray, alpha: float, beta: float) -> float:
    pods_used = int((counts.sum(axis=0) > 0).sum())
    t = int(max((row > 0).sum() for row in counts))
    return alpha * pods_used + beta * t


def _greedy_candidates(
    group_size: int, m: int, free: np.ndarray, alpha: float, beta: float
) -> tuple[np.ndarray | None, float]:
    best, best_obj = None, np.inf
    cands = [_greedy_whole(group_size, m, free)]
    caps = np.sort(free)[::-1]
    q_min = int(np.searchsorted(np.cumsum(caps), group_size * m) + 1)
    for q in range(q_min, min(len(free), q_min + 4) + 1):
        cands.append(_greedy_sequential(group_size, m, free, q))
    for c in cands:
        if c is None:
            continue
        obj = _counts_objective(c, alpha, beta)
        if obj < best_obj:
            best, best_obj = c, obj
    return best, best_obj


def _solve_counts(
    group_size: int,
    n_groups: int,
    free: np.ndarray,
    alpha: float,
    beta: float,
    integral_nodes: bool,
    time_limit: float,
    use_greedy_bound: bool = True,
) -> tuple[np.ndarray, float, float, str]:
    """Solve the scheduling problem; return (counts, objective, seconds, method).

    Fast path: identical groups make the MILP highly symmetric, so we first
    build greedy candidates and a provable lower bound; if they meet, the
    solver is skipped ("greedy-proven-optimal").  Otherwise the MILP runs
    under ``time_limit`` and the better of (incumbent, MILP) is returned.
    """
    k = len(free)
    m = n_groups
    if free.sum() < group_size * m:
        raise Infeasible(
            f"need {group_size * m} nodes, only {int(free.sum())} free"
        )

    t_start = time.perf_counter()
    incumbent, incumbent_obj = (None, np.inf)
    if use_greedy_bound:
        incumbent, incumbent_obj = _greedy_candidates(group_size, m, free, alpha, beta)
        lb = _objective_lower_bound(group_size, m, free, alpha, beta)
        if incumbent is not None and incumbent_obj <= lb + 1e-9:
            return incumbent, incumbent_obj, time.perf_counter() - t_start, "greedy-proven-optimal"

    # Variable layout: [ y_0..y_{k-1} | s_00..s_{m-1,k-1} | p_00.. | T ]
    n_y, n_s, n_p = k, m * k, m * k
    n_var = n_y + n_s + n_p + 1
    iy = lambda j: j
    is_ = lambda i, j: n_y + i * k + j
    ip = lambda i, j: n_y + n_s + i * k + j
    iT = n_var - 1

    c = np.zeros(n_var)
    c[:n_y] = alpha
    c[iT] = beta

    rows, cols, vals, lo, hi = [], [], [], [], []
    r = 0

    def add(entries, lb, ub):
        nonlocal r
        for col, val in entries:
            rows.append(r)
            cols.append(col)
            vals.append(val)
        lo.append(lb)
        hi.append(ub)
        r += 1

    # (Eq. 5) max spread: sum_j s_ij - T <= 0
    for i in range(m):
        add([(is_(i, j), 1.0) for j in range(k)] + [(iT, -1.0)], -np.inf, 0.0)
    # (Eq. 6) capacity: sum_i p_ij - c_j y_j <= 0,   c_j = free_j / group_size
    for j in range(k):
        cj = free[j] / group_size
        add([(ip(i, j), 1.0) for i in range(m)] + [(iy(j), -cj)], -np.inf, 0.0)
    # (Eq. 7) allocation: sum_j p_ij = 1
    for i in range(m):
        add([(ip(i, j), 1.0) for j in range(k)], 1.0, 1.0)
    # (Eq. 8) selection: p_ij - s_ij <= 0
    for i in range(m):
        for j in range(k):
            add([(ip(i, j), 1.0), (is_(i, j), -1.0)], -np.inf, 0.0)

    A = sp.csr_matrix(
        (vals, (rows, cols)), shape=(r, n_var)
    )
    constraints = LinearConstraint(A, lb=np.array(lo), ub=np.array(hi))

    lb = np.zeros(n_var)
    ub = np.ones(n_var)
    ub[iT] = k
    integrality = np.zeros(n_var)
    integrality[: n_y + n_s] = 1  # y, s binary
    if integral_nodes:
        # Make p_ij integral in units of 1/group_size: substitute q = p*gs.
        # scipy's milp has no scaling hook, so emulate via semi-integer trick:
        # declare p integral after scaling the column. Simplest robust path:
        # solve with p continuous first, then branch manually is overkill --
        # instead we scale the p-columns by declaring integrality on
        # n_ij = group_size * p_ij via a change of variable done by scaling
        # bounds and constraint coefficients.
        pass  # handled below by variable scaling

    if integral_nodes:
        # Change of variable: p'_ij = group_size * p_ij (integer node count).
        # Scale: objective has no p terms; constraints touching p get /gs.
        A = A.tolil()
        for i in range(m):
            for j in range(k):
                col = ip(i, j)
                A[:, col] = A[:, col] / group_size
        A = A.tocsr()
        constraints = LinearConstraint(A, lb=np.array(lo), ub=np.array(hi))
        ub[n_y + n_s : n_y + n_s + n_p] = group_size
        integrality[n_y + n_s : n_y + n_s + n_p] = 1

    with _silence_stdout():
        res = milp(
            c=c,
            constraints=constraints,
            integrality=integrality,
            bounds=Bounds(lb, ub),
            options={"time_limit": time_limit},
        )
    dt = time.perf_counter() - t_start
    if res.x is None:
        if incumbent is not None:
            return incumbent, incumbent_obj, dt, "greedy-incumbent"
        raise Infeasible(f"MILP failed: status={res.status} {res.message}")

    p = res.x[n_y + n_s : n_y + n_s + n_p].reshape(m, k)
    if integral_nodes:
        counts = np.rint(p).astype(int)
    else:
        counts = _round_counts(p, group_size, free)
    milp_obj = _counts_objective(counts, alpha, beta)
    if incumbent is not None and incumbent_obj < milp_obj:
        return incumbent, incumbent_obj, dt, "greedy-incumbent"
    return counts, milp_obj, dt, "milp"


def _round_counts(p: np.ndarray, group_size: int, free: np.ndarray) -> np.ndarray:
    """Largest-remainder rounding of fractional p to node counts, then a
    capacity repair pass (paper-faithful continuous relaxation needs this)."""
    m, k = p.shape
    counts = np.zeros((m, k), dtype=int)
    for i in range(m):
        raw = p[i] * group_size
        base = np.floor(raw).astype(int)
        rem = group_size - base.sum()
        order = np.argsort(-(raw - base))
        base[order[:rem]] += 1
        counts[i] = base
    # Repair: pod over capacity -> move surplus cells to pods with slack,
    # preferring pods the group already uses (keeps spread unchanged).
    used = counts.sum(axis=0)
    for j in range(k):
        while used[j] > free[j]:
            i = int(np.argmax(counts[:, j]))
            # candidate target pods, prefer ones group i already occupies
            slack = free - used
            cand = np.argsort(-(slack + 1000 * (counts[i] > 0)))
            moved = False
            for j2 in cand:
                if j2 != j and slack[j2] > 0:
                    counts[i, j] -= 1
                    counts[i, j2] += 1
                    used[j] -= 1
                    used[j2] += 1
                    moved = True
                    break
            if not moved:
                raise Infeasible("rounding repair could not satisfy capacity")
    return counts


def _counts_to_placement(
    comm: CommMatrix,
    cluster: Cluster,
    counts: np.ndarray,
    unit: str,
) -> Placement:
    """Materialize node assignments from per-(group, pod) counts.

    Columns are distributed to a row's pods in ascending pod-id order, so
    rows with identical pod allocations get identical column->pod maps and
    their DP groups align (this is the cross-group alignment the objective's
    ``sum_j y_j`` term buys).  Inside every minipod, cells are sorted by
    row-major rank and mapped to ascending free node ids -> contiguous ranks.
    """
    n_rows, n_cols = comm.shape
    if unit == "pp":
        groups = [(("row", r), n_cols) for r in range(n_rows)]
    else:
        groups = [(("col", c), n_rows) for c in range(n_cols)]

    # cell -> pod
    cell_pod = np.full((n_rows, n_cols), -1, dtype=int)
    for gi, ((kind, idx), size) in enumerate(groups):
        order = np.argsort(np.where(counts[gi] > 0, np.arange(counts.shape[1]), 1 << 30))
        pos = 0
        for j in order:
            c = int(counts[gi, j])
            if c == 0:
                continue
            for t in range(pos, pos + c):
                if kind == "row":
                    cell_pod[idx, t] = j
                else:
                    cell_pod[t, idx] = j
            pos += c
        assert pos == size

    # pod -> nodes, rank-contiguous
    assignment = np.full((n_rows, n_cols), -1, dtype=int)
    for j in range(counts.shape[1]):
        cells = [
            (r * n_cols + c, r, c)
            for r in range(n_rows)
            for c in range(n_cols)
            if cell_pod[r, c] == j
        ]
        if not cells:
            continue
        cells.sort()
        free_nodes = cluster.free_in_domain(j)
        if len(free_nodes) < len(cells):
            raise Infeasible(f"domain {j} lacks free nodes at materialization")
        for (rank, r, c), nid in zip(cells, free_nodes):
            assignment[r, c] = nid
    return Placement(comm=comm, assignment=assignment, cluster=cluster)


def schedule_mip(
    comm: CommMatrix,
    cluster: Cluster,
    alpha: float,
    beta: float | None = None,
    unit: str = "pp",
    integral_nodes: bool = True,
    time_limit: float = 10.0,
    use_greedy_bound: bool = True,
) -> MipResult:
    """Arnold's scheduler: solve Eq. 4-10 and materialize the placement.

    ``unit`` picks the scheduling-unit group: ``"pp"`` treats each PP group
    (matrix row) as one unit -- minimizing T consolidates PP chains while
    ``alpha * sum_j y_j`` consolidates the orthogonal DP groups; ``"dp"``
    swaps the roles (used when DP communication dominates, Appendix E).

    .. deprecated::
        Thin shim over the unified scheduler registry, kept only for
        backward compatibility: use
        ``get_scheduler("mip").schedule(ScheduleRequest(...))`` (see
        :mod:`repro_torch.core.scheduler` and DESIGN.md §2.4), which this
        delegates to before repackaging as a :class:`MipResult`.
    """
    import warnings

    from repro_torch.core.scheduler import ScheduleRequest, get_scheduler

    warnings.warn(
        "schedule_mip() is deprecated; use "
        'get_scheduler("mip").schedule(ScheduleRequest(...)) instead',
        DeprecationWarning,
        stacklevel=2,
    )

    request = ScheduleRequest(
        comm=comm,
        cluster=cluster,
        alpha=alpha,
        beta=beta,
        unit=unit,
        time_budget=time_limit,
        options={
            "integral_nodes": integral_nodes,
            "use_greedy_bound": use_greedy_bound,
        },
    )
    res = get_scheduler("mip").schedule(request)
    return MipResult(
        placement=res.placement,
        objective=res.objective,
        n_pods_used=res.stats["n_pods_used"],
        max_unit_spread=res.stats["max_unit_spread"],
        solve_seconds=res.solve_seconds,
        counts=res.stats["counts"],
        method=res.method,
    )
