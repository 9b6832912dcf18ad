"""Fabric protocol + registry: pluggable physical interconnects (DESIGN.md §9).

Arnold's spread objective was developed on one fabric -- the paper's
three-tier CLOS (§2, Fig. 2b) -- but the objective itself only needs a
notion of *locality domains* (sets of nodes with cheap mutual
communication) and a *hop distance* between those domains.  This module
makes that interface explicit so the scheduler stack, the spread metric,
and the network model can run on any interconnect:

* :class:`Fabric`          -- the protocol: node coordinates, locality
  domains, pairwise domain hop distance, bisection structure;
* :class:`BaseFabric`      -- shared implementation (domain index arrays,
  generic ``distance_at_spread``, contiguous scheduling blocks);
* a string-keyed registry (:func:`register_fabric`, :func:`get_fabric`,
  :func:`list_fabrics`) over fabric *classes*, mirroring the scheduler
  registry of :mod:`repro_torch.core.scheduler`.

Concrete fabrics (``clos``, ``rail-only``, ``torus``, ``dragonfly``) live
in sibling modules and register themselves on import of
:mod:`repro_torch.topo`.  The scheduling stack consumes fabrics through
:class:`repro_torch.core.topology.Cluster`, whose "minipods" are exactly the
fabric's domains -- on ``clos`` this reproduces the legacy minipod
hierarchy bit-for-bit, as the reference's does.
"""

from __future__ import annotations

import functools
import itertools
from typing import Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class Fabric(Protocol):
    """A physical interconnect at scheduling granularity.

    *Domains* are the fabric's locality unit (the generalization of the
    paper's minipod): communication inside a domain is treated as free by
    the spread metric, and crossing domains costs hop distance.  Node ids
    are dense ``0..n_nodes-1``; domain ids are dense ``0..n_domains-1``.
    """

    #: registry key of the fabric family ("clos", "torus", ...)
    kind: str

    @property
    def n_nodes(self) -> int: ...

    @property
    def n_domains(self) -> int: ...

    def domain_index(self) -> np.ndarray:
        """Node id -> domain id, as a dense int array of length n_nodes."""
        ...

    def domain_nodes(self, domain: int) -> list[int]:
        """Sorted node ids belonging to ``domain``."""
        ...

    def coords(self, node_id: int) -> tuple[int, ...]:
        """Physical coordinates of a node (fabric-specific axes)."""
        ...

    def domain_distance(self, a: int, b: int) -> int:
        """Hop distance between two domains (0 iff ``a == b``)."""
        ...

    def diameter(self) -> int:
        """Max domain-pairwise hop distance (>= 1 for multi-domain fabrics)."""
        ...

    def distance_at_spread(self, spread: int) -> int:
        """Tightest possible hop diameter of any set of ``spread`` domains.

        This is the optimistic locality profile the per-fabric network
        models use to turn a spread value into a degradation fraction
        when a concrete placement (with its exact hop diameter) is not
        in hand.
        """
        ...

    def partition(self, domains: Sequence[int]) -> tuple[list[int], list[int]]:
        """Bisection structure: split ``domains`` into two locality-coherent
        halves (used by recursive mapping heuristics)."""
        ...

    def scheduling_blocks(self, block_size: int) -> list[list[int]]:
        """Locality-coherent groups of <= ``block_size`` domains (the
        hierarchical tier's coarse units)."""
        ...


class BaseFabric:
    """Shared fabric mechanics: domain bookkeeping + generic distances.

    Subclasses provide ``kind``, per-domain node counts, and
    :meth:`domain_distance`; everything else has a correct (if not always
    tightest) default here.
    """

    kind = "base"

    def __init__(self, nodes_per_domain: Sequence[int]):
        counts = [int(c) for c in nodes_per_domain]
        if not counts or any(c <= 0 for c in counts):
            raise ValueError(f"nodes_per_domain must be positive, got {counts}")
        self._counts = counts
        self._domain_index = np.repeat(
            np.arange(len(counts)), counts
        ).astype(int)
        starts = np.concatenate([[0], np.cumsum(counts)])
        self._domain_nodes = [
            list(range(int(starts[d]), int(starts[d + 1])))
            for d in range(len(counts))
        ]

    # ------------------------------------------------------------- structure
    @property
    def n_nodes(self) -> int:
        return int(self._domain_index.size)

    @property
    def n_domains(self) -> int:
        return len(self._counts)

    def domain_index(self) -> np.ndarray:
        return self._domain_index

    def domain_nodes(self, domain: int) -> list[int]:
        return list(self._domain_nodes[domain])

    def coords(self, node_id: int) -> tuple[int, ...]:
        """Default coordinates: (domain, slot within domain)."""
        d = int(self._domain_index[node_id])
        return (d, node_id - self._domain_nodes[d][0])

    # ------------------------------------------------------------- distances
    def domain_distance(self, a: int, b: int) -> int:
        raise NotImplementedError

    def diameter(self) -> int:
        return self._diameter_cached()

    @functools.lru_cache(maxsize=None)
    def _diameter_cached(self) -> int:
        if self.n_domains <= 1:
            return 0
        return max(
            self.domain_distance(a, b)
            for a, b in itertools.combinations(range(self.n_domains), 2)
        )

    def distance_at_spread(self, spread: int) -> int:
        """Generic tightest q-domain ball diameter: for every center domain,
        take its ``spread`` nearest domains and measure that set's diameter;
        return the best center's value.  Exact and O(k^3)-ish -- fine at
        scheduling domain counts; regular fabrics override with closed
        forms."""
        q = int(spread)
        if q <= 1 or self.n_domains <= 1:
            return 0
        q = min(q, self.n_domains)
        return self._distance_at_spread_cached(q)

    @functools.lru_cache(maxsize=None)
    def _distance_at_spread_cached(self, q: int) -> int:
        k = self.n_domains
        dist = np.array(
            [[self.domain_distance(a, b) for b in range(k)] for a in range(k)]
        )
        best = None
        for center in range(k):
            ball = np.argsort(dist[center], kind="stable")[:q]
            diam = int(dist[np.ix_(ball, ball)].max())
            best = diam if best is None else min(best, diam)
        return int(best)

    # ------------------------------------------------------------- bisection
    def partition(self, domains: Sequence[int]) -> tuple[list[int], list[int]]:
        """Default bisection: split in id order (ids are laid out
        locality-major by construction in every built-in fabric)."""
        ds = list(domains)
        half = len(ds) // 2
        return ds[:half], ds[half:]

    def scheduling_blocks(self, block_size: int) -> list[list[int]]:
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        k = self.n_domains
        return [
            list(range(b, min(b + block_size, k)))
            for b in range(0, k, block_size)
        ]

    # ------------------------------------------------------------------ misc
    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"{type(self).__name__}(domains={self.n_domains}, "
            f"nodes={self.n_nodes})"
        )


# ---------------------------------------------------------------------------
# Registry (mirrors repro_torch.core.scheduler's policy registry).
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type] = {}
_ALIASES = {
    "rail": "rail-only",
    "railonly": "rail-only",
    "fat-tree": "clos",
    "minipod": "clos",
}


def _canon(name: str) -> str:
    key = name.strip().lower().replace("_", "-")
    return _ALIASES.get(key, key)


def register_fabric(name: str, cls: type | None = None, *, overwrite: bool = False):
    """Register a fabric class under ``name`` (usable as a decorator)."""

    def _register(obj: type) -> type:
        key = _canon(name)
        if key in _REGISTRY and not overwrite:
            raise ValueError(f"fabric {key!r} already registered")
        _REGISTRY[key] = obj
        return obj

    return _register if cls is None else _register(cls)


def get_fabric(name: str, *args, **kwargs) -> Fabric:
    """Instantiate the fabric registered under ``name``.

    Names are case-insensitive and ``_``/``-`` agnostic; construction
    arguments are forwarded to the fabric class
    (``get_fabric("torus", dims=(4, 4), nodes_per_domain=8)``).
    """
    key = _canon(name)
    try:
        cls = _REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"unknown fabric {name!r}; available: {list_fabrics()}"
        ) from None
    return cls(*args, **kwargs)


def fabric_class(name: str) -> type:
    """The registered class itself (for classmethod constructors)."""
    key = _canon(name)
    if key not in _REGISTRY:
        raise KeyError(f"unknown fabric {name!r}; available: {list_fabrics()}")
    return _REGISTRY[key]


def list_fabrics() -> list[str]:
    """Canonical names of all registered fabrics (aliases excluded)."""
    return sorted(_REGISTRY)
