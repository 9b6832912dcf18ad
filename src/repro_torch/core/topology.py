"""Physical data-center topology model (paper §2, Fig. 2b; DESIGN.md §9).

The paper's cluster is a three-tier CLOS: nodes -> leaf switches (s0, one
per rack) -> spine switches (s1, one *minipod* per spine group) -> core
switches.  Its characterization (§4) shows training performance is
dominated by the *minipod spread* of communication groups and is
insensitive to intra-minipod topology (<= 0.3% variation), so scheduling
is modeled at minipod granularity.

Since the fabric subsystem (:mod:`repro_torch.topo`), the minipod is one
instance of the general concept: a :class:`Cluster` is built from any
:class:`repro_torch.topo.Fabric`, whose *locality domains* play the minipod
role for every scheduler, the spread metric, and the network model.  The
legacy ``Cluster(nodes_per_minipod=...)`` constructor is the ``clos``
shorthand and behaves identically to the pre-fabric code.

The port's copy of the reference's ``core/topology.py``: the same cluster
model, bit for bit, in numpy.  A node is 8 accelerators (an HGX H100 node
has 8 cards, like the paper's H800 nodes).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.topo import ClosFabric, Fabric

GPUS_PER_NODE = 8


@dataclasses.dataclass(frozen=True)
class Node:
    """A compute node: 8 accelerators under one NIC/leaf switch.

    ``minipod`` is the node's fabric *domain* id (the historical name is
    kept; prefer :meth:`Cluster.domain_of` / ``Cluster.fabric`` for
    fabric-generic code).
    """

    node_id: int
    minipod: int
    rack: int
    gpus: int = GPUS_PER_NODE


@dataclasses.dataclass
class Minipod:
    """One fabric locality domain (a spine group on ``clos``, a rail group
    on ``rail-only``, a torus vertex, a dragonfly router)."""

    pod_id: int
    node_ids: list[int]

    @property
    def capacity(self) -> int:
        return len(self.node_ids)


#: fabric-generic alias for :class:`Minipod`.
Domain = Minipod


class Cluster:
    """A cluster of nodes over a pluggable fabric, at domain granularity.

    Tracks free/busy nodes; scheduling algorithms allocate from here.
    ``Cluster(nodes_per_minipod=[...])`` is the ``clos`` shorthand
    (builds a :class:`repro_torch.topo.ClosFabric`); any other fabric comes in
    through ``Cluster(fabric=...)`` / :meth:`from_fabric`.
    """

    def __init__(
        self,
        nodes_per_minipod: Optional[Sequence[int]] = None,
        nodes_per_rack: int = 8,
        *,
        fabric: Optional[Fabric] = None,
    ):
        if (nodes_per_minipod is None) == (fabric is None):
            raise ValueError(
                "pass exactly one of nodes_per_minipod (clos shorthand) "
                "or fabric"
            )
        if fabric is None:
            fabric = ClosFabric(nodes_per_minipod, nodes_per_rack=nodes_per_rack)
        self.fabric: Fabric = fabric
        #: node id -> domain id, precomputed for hot-path vectorized lookups
        #: (see Placement.domain_of in core/spread.py).
        self.domain_index: np.ndarray = np.asarray(fabric.domain_index(), dtype=int)

        self.minipods: list[Minipod] = []
        self.nodes: dict[int, Node] = {}
        rack_size = getattr(fabric, "nodes_per_rack", nodes_per_rack)
        for pod_id in range(fabric.n_domains):
            ids = fabric.domain_nodes(pod_id)
            for slot, nid in enumerate(ids):
                self.nodes[nid] = Node(
                    node_id=nid, minipod=pod_id, rack=slot // rack_size
                )
            self.minipods.append(Minipod(pod_id=pod_id, node_ids=list(ids)))
        # Free state is a boolean mask plus incrementally-maintained counters
        # (DESIGN.md §10): allocate/release are O(k) mask writes, n_free is an
        # O(1) counter read, free_capacities/free_signature are O(n_domains)
        # counter reads, and free_in_domain is a vectorized mask-select over
        # the (sorted, precomputed) per-domain node-id array.
        n = len(self.nodes)
        self._free_mask: np.ndarray = np.ones(n, dtype=bool)
        self._free_count: int = n
        self._domain_nodes_arr: list[np.ndarray] = [
            np.asarray(sorted(p.node_ids), dtype=np.int64) for p in self.minipods
        ]
        self._domain_free: np.ndarray = np.asarray(
            [p.capacity for p in self.minipods], dtype=np.int64
        )

    # ------------------------------------------------------------------ state
    @property
    def n_minipods(self) -> int:
        """Number of fabric domains (historical name; same as
        :attr:`n_domains`)."""
        return len(self.minipods)

    @property
    def n_domains(self) -> int:
        return len(self.minipods)

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def n_free(self) -> int:
        return self._free_count

    def domain_of(self, node_id: int) -> int:
        """Fabric domain id of a node (O(1) array lookup)."""
        return int(self.domain_index[node_id])

    def free_in_minipod(self, pod_id: int) -> list[int]:
        """Free nodes of one domain, sorted.  Historical ``clos`` name for
        :meth:`free_in_domain`; both work on every fabric."""
        arr = self._domain_nodes_arr[pod_id]
        return arr[self._free_mask[arr]].tolist()

    #: fabric-generic alias (the supported name for new code).
    free_in_domain = free_in_minipod

    def free_capacities(self) -> list[int]:
        return self._domain_free.tolist()

    def free_signature(self, quantum: int = 1) -> tuple[int, ...]:
        """Hashable free-capacity fingerprint: per-domain free counts
        rounded *down* to a multiple of ``quantum`` nodes.

        This is the canonical way to compare free-pool states (placement
        cache keys, benchmark workload fingerprints) -- rounding down means
        two states sharing a signature differ by less than ``quantum``
        nodes in any domain, so a placement solved for one is usually
        still near-optimal for the other (DESIGN.md §8.3).  Reads the
        per-domain free counters directly, so it is O(n_domains) -- it is
        the placement-cache key and therefore itself a hot path.
        """
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        return tuple(((self._domain_free // quantum) * quantum).tolist())

    def is_free(self, node_id: int) -> bool:
        nid = int(node_id)
        return 0 <= nid < self._free_mask.size and bool(self._free_mask[nid])

    def free_node_ids(self) -> np.ndarray:
        """All free node ids as a sorted int array (one vectorized scan)."""
        return np.flatnonzero(self._free_mask)

    def free_mask_view(self) -> np.ndarray:
        """Read-only view of the free mask (index = node id).  Callers must
        not write through it; use :meth:`allocate`/:meth:`release`."""
        view = self._free_mask.view()
        view.flags.writeable = False
        return view

    # ------------------------------------------------------- fabric structure
    def domain_distance(self, a: int, b: int) -> int:
        """Hop distance between two domains (delegates to the fabric)."""
        return self.fabric.domain_distance(a, b)

    def partition_domains(
        self, domains: Sequence[int]
    ) -> tuple[list[int], list[int]]:
        """Fabric-aware bisection of a domain set (recursive mappers)."""
        return self.fabric.partition(domains)

    def scheduling_blocks(self, block_size: int) -> list[list[int]]:
        """Locality-coherent domain blocks for the hierarchical tier."""
        return self.fabric.scheduling_blocks(block_size)

    # ------------------------------------------------------------- transitions
    def _as_id_array(self, node_ids: Iterable[int]) -> np.ndarray:
        """Validated, de-duplicated id array (duplicates within one call
        collapse, matching the historical set semantics)."""
        ids_list = node_ids if type(node_ids) is list else list(node_ids)
        ids = np.asarray(ids_list, dtype=np.int64)
        if ids.size > 1 and len(set(ids_list)) != ids.size:
            ids = np.unique(ids)
        return ids

    def allocate(self, node_ids: Iterable[int]) -> None:
        ids = self._as_id_array(node_ids)
        if ids.size == 0:
            return
        n = self._free_mask.size
        if int(ids.min()) < 0 or int(ids.max()) >= n:
            raise ValueError(
                f"nodes not free: {[i for i in ids.tolist() if not 0 <= i < n]}"
            )
        taken = self._free_mask[ids]
        if not taken.all():
            raise ValueError(f"nodes not free: {ids[~taken].tolist()}")
        self._free_mask[ids] = False
        self._free_count -= int(ids.size)
        self._domain_free -= np.bincount(
            self.domain_index[ids], minlength=self.n_domains
        )

    def release(self, node_ids: Iterable[int]) -> None:
        ids = self._as_id_array(node_ids)
        if ids.size == 0:
            return
        n = self._free_mask.size
        if int(ids.min()) < 0 or int(ids.max()) >= n:
            bad = next(i for i in ids.tolist() if not 0 <= i < n)
            raise ValueError(f"unknown node {bad}")
        already = self._free_mask[ids]
        if already.any():  # releasing a free node is a no-op
            ids = ids[~already]
        self._free_mask[ids] = True
        self._free_count += int(ids.size)
        self._domain_free += np.bincount(
            self.domain_index[ids], minlength=self.n_domains
        )

    def snapshot_free(self) -> set[int]:
        """Set-typed compatibility view of the free pool (a copy)."""
        return set(np.flatnonzero(self._free_mask).tolist())

    # ---------------------------------------------------------------- factories
    @classmethod
    def from_fabric(cls, fabric: Fabric) -> "Cluster":
        """Cluster over an explicit fabric instance."""
        return cls(fabric=fabric)

    @classmethod
    def uniform(cls, n_minipods: int, nodes_per_minipod: int, **kw) -> "Cluster":
        return cls([nodes_per_minipod] * n_minipods, **kw)

    @classmethod
    def paper_setting(cls, which: str) -> "Cluster":
        """Benchmark topologies from Table 1 (subsets of the production cluster).

        ``{x}, {y}`` = x minipods, y nodes total.  Nodes are spread as evenly
        as possible across minipods (the paper does not publish the per-pod
        distribution of its subsets).
        """
        spec = {"i": (3, 18), "ii": (5, 438), "iii": (11, 1019)}[which]
        pods, total = spec
        base, rem = divmod(total, pods)
        return cls([base + (1 if i < rem else 0) for i in range(pods)])

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        caps = self.free_capacities()
        return (
            f"Cluster(fabric={self.fabric.kind}, domains={self.n_domains}, "
            f"nodes={self.n_nodes}, free={caps})"
        )
