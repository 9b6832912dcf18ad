"""Placement cache for recurring job shapes (DESIGN.md §8.3).

Continuous job churn on a 10k-node cluster re-solves near-identical
placement problems all day: the same model/parallelism template arrives
many times, and between arrivals the free pool drifts by only a few nodes.
The cache memoizes the solved **counts matrix** (nodes per scheduling-unit
group per minipod) -- deliberately *not* node ids, which change as jobs
come and go -- keyed on everything that determines the solve:

    (matrix shape, scheduling unit, affinity weights,
     quantized free-capacity signature)

Free capacities enter the key through :meth:`Cluster.free_signature`, which
rounds each minipod's free count down to a multiple of ``quantum`` nodes.
(Since the mask-based free state, DESIGN.md §10.1, that signature is an
O(n_minipods) read of incrementally-maintained counters, so probing the
cache on every solve costs nothing proportional to cluster size.)
Quantization is what makes the cache useful: without it, a single node
allocated anywhere in the cluster would change the key and nothing would
ever hit.  A hit is revalidated against the *exact* current free
capacities before any placement is materialized, so a stale entry can
never produce an infeasible placement -- it just counts as a miss.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Hashable, Optional

import numpy as np

from repro_torch.core.comm_matrix import CommMatrix
from repro_torch.core.topology import Cluster

CacheKey = tuple


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": round(self.hit_rate(), 4)}


class PlacementCache:
    """LRU cache of solved counts matrices, validated on every hit.

    ``quantum`` is the free-capacity quantization step (nodes); ``maxsize``
    bounds memory (oldest entry evicted first).  Thread-unsafe by design:
    schedulers run in the single-threaded scheduling loop.
    """

    def __init__(self, quantum: int = 8, maxsize: int = 256):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.quantum = quantum
        self.maxsize = maxsize
        self._entries: OrderedDict[CacheKey, np.ndarray] = OrderedDict()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------------ key
    def key(
        self,
        comm: CommMatrix,
        cluster: Cluster,
        unit: str,
        alpha: float,
        beta: float,
        extra: Hashable = (),
    ) -> CacheKey:
        """Cache key for one placement problem.

        ``extra`` lets a scheduler fold in algorithm knobs that change the
        solution (e.g. the hierarchical block size).
        """
        return (
            comm.shape,
            unit,
            round(float(alpha), 6),
            round(float(beta), 6),
            cluster.n_minipods,
            cluster.free_signature(self.quantum),
            extra,
        )

    # --------------------------------------------------------------- lookup
    def lookup(self, key: CacheKey, free: np.ndarray) -> Optional[np.ndarray]:
        """Return validated counts for ``key``, or None (counts a miss).

        Validation: the cached per-minipod demands must fit the *exact*
        current free capacities (quantized signatures can match while a pod
        lost a node the cached solution needs).
        """
        entry = self._entries.get(key)
        if entry is not None and (entry.sum(axis=0) <= np.asarray(free)).all():
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return entry.copy()
        self.stats.misses += 1
        return None

    def store(self, key: CacheKey, counts: np.ndarray) -> None:
        self._entries[key] = np.asarray(counts, dtype=int).copy()
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        self._entries.clear()
        self.stats = CacheStats()
