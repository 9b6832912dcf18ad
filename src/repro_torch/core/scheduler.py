"""Unified scheduler API: one request/result contract for every placement
algorithm (DESIGN.md §2.4).

Arnold's value is that a *single* placement contract flows from workload
characterization to the training framework (paper §5-§6).  This module makes
that contract explicit:

* :class:`ScheduleRequest`  -- everything a placement decision needs (comm
  matrix, cluster, affinity weights, scheduling unit, excluded/reserved node
  sets, solver time budget, RNG seed);
* :class:`ScheduleResult`   -- everything a caller may want back (placement,
  objective, per-axis max spreads, solve stats, method string);
* :class:`Scheduler`        -- the protocol: ``schedule(request) -> result``;
* a string-keyed registry (:func:`register_scheduler`, :func:`get_scheduler`,
  :func:`list_schedulers`) over which the MILP and all four baselines are
  exposed as interchangeable policies;
* :class:`FallbackChain`    -- the first composite the redesign enables:
  try policies in order, degrading gracefully on :class:`Infeasible` or
  solver time-budget exhaustion (e.g. ``FallbackChain("mip", "topo-aware")``).

The legacy entry points (``schedule_mip`` and the baseline functions in
:mod:`repro_torch.core.baselines`) are deprecated thin shims over this registry
(they warn on call); the registry is the only supported entry point
(DESIGN.md §2.4).  The ``"hier"`` scale tier
(:mod:`repro_torch.core.hierarchical`) registers here too and composes as
``FallbackChain("hier", "mip", "topo-aware")``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Iterator, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.comm_matrix import CommMatrix
from repro_torch.core.mip import Infeasible, _counts_to_placement, _solve_counts
from repro_torch.core.spread import Placement, max_spreads, weighted_spread
from repro_torch.core.topology import Cluster


# ---------------------------------------------------------------------------
# Request / result contract
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScheduleRequest:
    """One placement problem, algorithm-agnostic.

    ``alpha``/``beta`` are the Eq. 2 affinity weights (``beta`` defaults to
    ``1 - alpha``); ``unit`` picks the scheduling-unit group ("pp" rows or
    "dp" columns, §5.2).  ``excluded_nodes`` are unusable (failed/unhealthy)
    nodes; ``reserved_nodes`` are held for another job -- both are masked
    from the free pool for the duration of the solve.  ``time_budget`` caps
    solver wall-clock (MILP time limit); heuristic policies ignore it.
    ``seed``/``rng`` make randomized policies reproducible (``rng`` wins
    when both are given).

    ``prev_placement``/``dirty_nodes`` are the warm-start contract
    (DESIGN.md §8.2): a caller re-solving after incremental churn (a
    failure, a few nodes drained) passes the placement it already has plus
    the set of node ids that changed; a warm-start-capable scheduler
    ("hier") repairs the placement locally instead of re-solving from
    scratch, and every other scheduler simply ignores the hint -- so the
    fields are safe to set unconditionally.
    """

    comm: CommMatrix
    cluster: Cluster
    alpha: float = 0.5
    beta: Optional[float] = None
    unit: str = "pp"
    excluded_nodes: frozenset[int] = frozenset()
    reserved_nodes: frozenset[int] = frozenset()
    time_budget: float = 10.0
    seed: int = 0
    rng: Optional[np.random.Generator] = None
    prev_placement: Optional[Placement] = None
    dirty_nodes: frozenset[int] = frozenset()
    options: dict = dataclasses.field(default_factory=dict)  # method-specific

    def __post_init__(self):
        if self.unit not in ("pp", "dp"):
            raise ValueError(f"unit must be pp|dp, got {self.unit}")
        if self.alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")
        self.excluded_nodes = frozenset(self.excluded_nodes)
        self.reserved_nodes = frozenset(self.reserved_nodes)
        self.dirty_nodes = frozenset(self.dirty_nodes)

    def resolved_beta(self) -> float:
        return 1.0 - self.alpha if self.beta is None else self.beta

    def resolved_rng(self) -> np.random.Generator:
        return self.rng if self.rng is not None else np.random.default_rng(self.seed)

    def masked_nodes(self) -> frozenset[int]:
        return self.excluded_nodes | self.reserved_nodes

    @contextlib.contextmanager
    def masked_cluster(self) -> Iterator[Cluster]:
        """Cluster view with excluded/reserved nodes taken out of the free
        pool; the cluster's free set is restored on exit."""
        mask = [n for n in sorted(self.masked_nodes()) if self.cluster.is_free(n)]
        self.cluster.allocate(mask)
        try:
            yield self.cluster
        finally:
            self.cluster.release(mask)


@dataclasses.dataclass
class ScheduleResult:
    """Outcome of one placement decision.

    ``objective`` is method-specific (the MILP's Eq. 4 value for "mip", the
    Eq. 2 weighted spread for the heuristics); ``dp_spread``/``pp_spread``
    are the method-independent comparison metric (Eq. 3 max spreads).
    ``method`` records what actually produced the placement ("milp",
    "greedy-proven-optimal", a baseline name, ...); ``stats`` carries
    method-specific extras (MILP counts, fallback-chain attempts, ...).
    """

    placement: Placement
    objective: float
    dp_spread: int
    pp_spread: int
    solve_seconds: float
    method: str
    stats: dict = dataclasses.field(default_factory=dict)

    def n_pods_used(self) -> int:
        """Distinct fabric domains (minipods on ``clos``) the placement
        touches."""
        return int(len(np.unique(self.placement.domain_of())))

    def weighted_spread(self, alpha: float, beta: Optional[float] = None) -> float:
        """Eq. 2 metric of this placement (validates ``alpha + beta == 1``)."""
        return weighted_spread(self.placement, alpha, beta)


@runtime_checkable
class Scheduler(Protocol):
    """Anything that turns a :class:`ScheduleRequest` into a
    :class:`ScheduleResult` (raising :class:`Infeasible` when it cannot)."""

    name: str

    def schedule(self, request: ScheduleRequest) -> ScheduleResult:
        ...


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Scheduler] = {}
_ALIASES = {"milp": "mip", "arnold": "mip", "hierarchical": "hier", "scale": "hier"}


def _canon(name: str) -> str:
    key = name.strip().lower().replace("_", "-")
    return _ALIASES.get(key, key)


def register_scheduler(
    name: str, scheduler: Optional[Scheduler] = None, *, overwrite: bool = False
):
    """Register ``scheduler`` under ``name`` (also usable as a decorator on a
    Scheduler class, which is instantiated with no arguments)."""
    def _register(obj):
        sched = obj() if isinstance(obj, type) else obj
        key = _canon(name)
        if key in _REGISTRY and not overwrite:
            raise ValueError(f"scheduler {key!r} already registered")
        _REGISTRY[key] = sched
        return obj

    return _register if scheduler is None else _register(scheduler)


def get_scheduler(spec: "str | Scheduler") -> Scheduler:
    """Resolve a scheduler by name or pass an instance through.

    Names are case-insensitive and ``_``/``-`` agnostic ("topo_aware" ==
    "topo-aware"); a comma-separated list ("mip,topo-aware") resolves to a
    :class:`FallbackChain` over the parts.
    """
    if not isinstance(spec, str):
        if isinstance(spec, Scheduler):
            return spec
        raise TypeError(f"expected scheduler name or instance, got {type(spec)}")
    if "," in spec:
        return FallbackChain(*[part for part in spec.split(",") if part.strip()])
    key = _canon(spec)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"unknown scheduler {spec!r}; available: {list_schedulers()}"
        ) from None


def list_schedulers() -> list[str]:
    """Canonical names of all registered schedulers (aliases excluded)."""
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Concrete schedulers
# ---------------------------------------------------------------------------

class MipScheduler:
    """Arnold's MILP (Eq. 4-10) behind the unified contract.

    ``request.time_budget`` is the solver time limit; ``request.options``
    accepts the MILP knobs ``integral_nodes`` (default True) and
    ``use_greedy_bound`` (default True).
    """

    name = "mip"

    def schedule(self, request: ScheduleRequest) -> ScheduleResult:
        comm = request.comm
        beta = request.resolved_beta()
        n_groups = comm.n_rows if request.unit == "pp" else comm.n_cols
        group_size = comm.n_cols if request.unit == "pp" else comm.n_rows
        with request.masked_cluster() as cluster:
            free = np.array(cluster.free_capacities(), dtype=float)
            counts, obj, dt, method = _solve_counts(
                group_size,
                n_groups,
                free,
                request.alpha,
                beta,
                request.options.get("integral_nodes", True),
                request.time_budget,
                use_greedy_bound=request.options.get("use_greedy_bound", True),
            )
            placement = _counts_to_placement(comm, cluster, counts, request.unit)
        dp_s, pp_s = max_spreads(placement)
        return ScheduleResult(
            placement=placement,
            objective=obj,
            dp_spread=dp_s,
            pp_spread=pp_s,
            solve_seconds=dt,
            method=method,
            stats={
                "counts": counts,
                "n_pods_used": int((counts.sum(axis=0) > 0).sum()),
                "max_unit_spread": int(max((row > 0).sum() for row in counts)),
            },
        )


class FunctionScheduler:
    """Adapts a ``fn(comm, cluster, **kw) -> Placement`` heuristic to the
    Scheduler protocol (used for the four §7.1 baselines)."""

    def __init__(self, name: str, fn: Callable[..., Placement], *, wants_rng: bool = False):
        self.name = name
        self._fn = fn
        self._wants_rng = wants_rng

    def schedule(self, request: ScheduleRequest) -> ScheduleResult:
        t0 = time.perf_counter()
        kw = {"rng": request.resolved_rng()} if self._wants_rng else {}
        with request.masked_cluster() as cluster:
            placement = self._fn(request.comm, cluster, **kw)
        dt = time.perf_counter() - t0
        dp_s, pp_s = max_spreads(placement)
        return ScheduleResult(
            placement=placement,
            objective=request.alpha * dp_s + request.resolved_beta() * pp_s,
            dp_spread=dp_s,
            pp_spread=pp_s,
            solve_seconds=dt,
            method=self.name,
        )


class FallbackChain:
    """Try schedulers in order; return the first feasible, on-time result.

    Links may be names or instances and are resolved lazily at schedule
    time, so a chain can reference policies registered after construction.
    ``request.time_budget`` is the budget for the *whole chain*: each link
    runs with the budget remaining when it starts, and a link fails either
    by raising :class:`Infeasible` -- which the MILP also raises on
    time-budget exhaustion without an incumbent -- or by returning only
    after its remaining budget is spent (a placement delivered past the
    deadline is useless to a real-time scheduling loop, so the chain
    discards it and degrades to the next, cheaper link).  The final link is
    exempt from the overrun check: a late placement beats no placement.

    The winning result's ``stats["served_by"]`` records which link
    produced it and ``stats["fallbacks"]`` the failed attempts; if every
    link fails, one aggregate :class:`Infeasible` is raised.
    """

    def __init__(self, *schedulers: "str | Scheduler", name: Optional[str] = None):
        if not schedulers:
            raise ValueError("FallbackChain needs at least one scheduler")
        self._links = list(schedulers)
        self.name = name or "fallback(" + ",".join(
            s if isinstance(s, str) else getattr(s, "name", type(s).__name__)
            for s in schedulers
        ) + ")"

    def schedule(self, request: ScheduleRequest) -> ScheduleResult:
        failures: list[tuple[str, str]] = []
        t_start = time.perf_counter()
        for i, link in enumerate(self._links):
            sched = get_scheduler(link)
            remaining = request.time_budget - (time.perf_counter() - t_start)
            if remaining <= 0 and i < len(self._links) - 1:
                # Out of budget: skip straight to the last (cheapest) link
                # rather than burning more time on expensive middle links.
                failures.append((sched.name, "chain time budget exhausted"))
                continue
            sub = dataclasses.replace(request, time_budget=max(remaining, 0.0))
            t_link = time.perf_counter()
            try:
                result = sched.schedule(sub)
            except Infeasible as exc:
                failures.append((sched.name, str(exc)))
                continue
            elapsed = time.perf_counter() - t_link
            if elapsed > remaining and i < len(self._links) - 1:
                failures.append((
                    sched.name,
                    f"exceeded time budget ({elapsed:.3f}s > {remaining:.3f}s)",
                ))
                continue
            result.stats = dict(result.stats, served_by=sched.name)
            if failures:
                result.stats["fallbacks"] = list(failures)
            return result
        detail = "; ".join(f"{n}: {msg}" for n, msg in failures)
        raise Infeasible(f"all schedulers in {self.name} failed: {detail}")


def _register_builtin_schedulers() -> None:
    # Imported here (not at module top) only to keep the privates' origin
    # obvious; baselines.py itself never imports this module at import time,
    # so there is no cycle either way.  hierarchical.py *does* import this
    # module, but by the time this function runs (module bottom) every name
    # it needs is defined.
    from repro_torch.core import baselines
    from repro_torch.core.hierarchical import HierarchicalScheduler

    register_scheduler("mip", MipScheduler())
    register_scheduler("hier", HierarchicalScheduler())
    register_scheduler("best-fit", FunctionScheduler("best-fit", baselines._best_fit))
    register_scheduler(
        "random-fit",
        FunctionScheduler("random-fit", baselines._random_fit, wants_rng=True),
    )
    register_scheduler(
        "gpu-packing", FunctionScheduler("gpu-packing", baselines._gpu_packing)
    )
    register_scheduler(
        "topo-aware", FunctionScheduler("topo-aware", baselines._topo_aware)
    )


_register_builtin_schedulers()
