"""Seeded generators of reproducible fault traces (DESIGN.md §11.1).

The paper's Limitations section treats hardware failure as an
afterthought -- a ``(time, node_id)`` list fed to the simulator.  Real
clusters fail in *correlated bursts*: a ToR switch or an optical rail
takes out an entire locality domain at once, stragglers degrade a job
without killing it, and most faults are transient (the node returns to
service after a reboot or link flap).  arXiv:2407.20018 §6 surveys the
taxonomy; this module encodes it as four seeded generators whose union is
a reproducible :class:`FaultEvent` trace:

* **independent node faults** -- a Poisson process at aggregate rate
  ``n_nodes / node_mtbf_s`` (superposition of per-node exponential MTBF
  clocks, identical in distribution and vectorizable);
* **correlated domain outages** -- whole-domain blasts whose radius
  follows the fabric structure of :mod:`repro_torch.topo`: a minipod on
  ``clos``, a rail group on ``rail-only``, a board on ``torus``, a
  router group on ``dragonfly`` (the fabric's locality domain *is* the
  shared failure domain -- one spine/rail/router serves exactly its
  nodes);
* **stragglers** -- soft faults: a node keeps running but multiplies the
  step time of any synchronous job it participates in;
* **transient vs permanent** -- every hard fault is transient with
  probability ``transient_frac`` and returns to service after an
  exponential time-to-repair; permanent faults never return.

Determinism contract: the trace is a pure function of ``(config, seed,
fabric shape, t_end)`` -- same seed, bit-identical trace (and therefore
bit-identical ``SimResult`` downstream).

The port's copy of the reference's ``faults/model.py``: the same draws in
the same order, so the same seed gives the reference's trace byte for byte.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import numpy as np

from repro_torch.topo import Fabric

#: event kinds, in tie-break priority order at equal timestamps.
KINDS = ("domain", "node", "straggler")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault: a set of nodes goes down (or slow) at time ``t``.

    ``nodes`` is the blast radius -- a single node for ``kind="node"`` /
    ``"straggler"``, a whole locality domain for ``kind="domain"``.
    Transient faults return to service ``ttr_s`` after ``t``; permanent
    ones never do.  ``slowdown`` (> 1, stragglers only) multiplies the
    step time of an affected synchronous job for ``ttr_s`` seconds.
    """

    t: float
    kind: str                   # "node" | "domain" | "straggler"
    nodes: tuple[int, ...]
    transient: bool = True
    ttr_s: float = 0.0
    slowdown: float = 1.0
    domain: int = -1            # locality domain id for kind="domain"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if not self.nodes:
            raise ValueError("a fault needs at least one node")


@dataclasses.dataclass(frozen=True)
class FaultModelConfig:
    """Failure-rate calibration (arXiv:2407.20018 §6 ballpark).

    Defaults target a production-scale month: at 9984 nodes a 120-day
    node MTBF yields ~2500 node faults over 30 days (~3.5/hour, the
    LLaMA-3/OPT-train-log regime), a 3-year per-domain MTBF yields a
    handful of correlated domain blasts, and ~1 straggler/day emerges.
    """

    node_mtbf_s: float = 120 * 86400.0       # per-node exponential MTBF
    domain_mtbf_s: float = 1095 * 86400.0    # per-domain outage MTBF (0 = off)
    straggler_mtbf_s: float = 300 * 86400.0  # per-node straggle MTBF (0 = off)
    transient_frac: float = 0.6              # node faults that return
    domain_transient_frac: float = 0.9       # domain outages that return
    mean_ttr_s: float = 2 * 3600.0           # node return-to-service
    mean_domain_ttr_s: float = 4 * 3600.0    # domain return-to-service
    min_ttr_s: float = 120.0
    straggler_slowdown: tuple[float, float] = (1.25, 3.0)
    mean_straggle_s: float = 2 * 3600.0      # straggler episode length

    def __post_init__(self):
        if self.node_mtbf_s <= 0:
            raise ValueError("node_mtbf_s must be positive")
        lo, hi = self.straggler_slowdown
        if not 1.0 < lo <= hi:
            raise ValueError(
                f"straggler_slowdown must be 1 < lo <= hi, got {(lo, hi)}"
            )


class FaultModel:
    """Reproducible fault-trace generator over a fabric.

    >>> fm = FaultModel(seed=7)
    >>> events = fm.generate(cluster.fabric, t_end=30 * 86400.0)

    Each generator stream draws its fields in one vectorized batch, so a
    month-scale trace at 10k nodes is milliseconds.  ``generate`` is pure:
    calling it twice returns equal traces (a fresh generator is derived
    from the stored seed on every call).
    """

    def __init__(self, config: FaultModelConfig | None = None, seed: int = 0,
                 **overrides):
        if overrides:
            config = dataclasses.replace(config or FaultModelConfig(),
                                         **overrides)
        self.config = config or FaultModelConfig()
        self.seed = int(seed)

    # ------------------------------------------------------------- generation
    def generate(self, fabric: Fabric, t_end: float) -> list[FaultEvent]:
        """The fault trace over ``[0, t_end)``, sorted by time (ties broken
        by kind priority -- domain blasts first -- then draw order)."""
        cfg = self.config
        rng = np.random.default_rng(self.seed)
        events: list[FaultEvent] = []
        events += self._domain_outages(rng, fabric, t_end)
        events += self._node_faults(rng, fabric, t_end)
        events += self._stragglers(rng, fabric, t_end)
        order = {k: i for i, k in enumerate(KINDS)}
        events.sort(key=lambda e: (e.t, order[e.kind], e.nodes))
        return events

    def _poisson_times(self, rng: np.random.Generator, rate_per_s: float,
                       t_end: float) -> np.ndarray:
        """Arrival times of a Poisson process at ``rate_per_s`` on
        ``[0, t_end)`` -- count first, then sorted uniforms (exact)."""
        n = int(rng.poisson(rate_per_s * t_end))
        return np.sort(rng.uniform(0.0, t_end, size=n))

    def _ttrs(self, rng: np.random.Generator, n: int, mean: float) -> np.ndarray:
        return np.maximum(rng.exponential(mean, size=n), self.config.min_ttr_s)

    def _node_faults(self, rng, fabric, t_end) -> list[FaultEvent]:
        cfg = self.config
        if cfg.node_mtbf_s <= 0:
            return []
        times = self._poisson_times(rng, fabric.n_nodes / cfg.node_mtbf_s, t_end)
        n = times.size
        nodes = rng.integers(0, fabric.n_nodes, size=n)
        transient = rng.random(size=n) < cfg.transient_frac
        ttrs = self._ttrs(rng, n, cfg.mean_ttr_s)
        return [
            FaultEvent(
                t=float(times[i]), kind="node", nodes=(int(nodes[i]),),
                transient=bool(transient[i]),
                ttr_s=float(ttrs[i]) if transient[i] else 0.0,
            )
            for i in range(n)
        ]

    def _domain_outages(self, rng, fabric, t_end) -> list[FaultEvent]:
        cfg = self.config
        if cfg.domain_mtbf_s <= 0 or fabric.n_domains == 0:
            return []
        times = self._poisson_times(
            rng, fabric.n_domains / cfg.domain_mtbf_s, t_end)
        n = times.size
        domains = rng.integers(0, fabric.n_domains, size=n)
        transient = rng.random(size=n) < cfg.domain_transient_frac
        ttrs = self._ttrs(rng, n, cfg.mean_domain_ttr_s)
        return [
            FaultEvent(
                t=float(times[i]), kind="domain",
                nodes=tuple(fabric.domain_nodes(int(domains[i]))),
                transient=bool(transient[i]),
                ttr_s=float(ttrs[i]) if transient[i] else 0.0,
                domain=int(domains[i]),
            )
            for i in range(n)
        ]

    def _stragglers(self, rng, fabric, t_end) -> list[FaultEvent]:
        cfg = self.config
        if cfg.straggler_mtbf_s <= 0:
            return []
        times = self._poisson_times(
            rng, fabric.n_nodes / cfg.straggler_mtbf_s, t_end)
        n = times.size
        nodes = rng.integers(0, fabric.n_nodes, size=n)
        lo, hi = cfg.straggler_slowdown
        slowdowns = rng.uniform(lo, hi, size=n)
        durations = self._ttrs(rng, n, cfg.mean_straggle_s)
        return [
            FaultEvent(
                t=float(times[i]), kind="straggler", nodes=(int(nodes[i]),),
                transient=True, ttr_s=float(durations[i]),
                slowdown=float(slowdowns[i]),
            )
            for i in range(n)
        ]


def trace_digest(events: Sequence[FaultEvent]) -> str:
    """Stable hex digest of a fault trace (full float precision), used by
    the determinism tests and the benchmark parity checksum."""
    h = hashlib.sha256()
    for e in events:
        h.update(repr((e.t, e.kind, e.nodes, e.transient, e.ttr_s,
                       e.slowdown, e.domain)).encode())
    return h.hexdigest()
