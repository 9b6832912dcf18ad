"""2D/3D torus fabric (DESIGN.md §3).

Domains are torus vertices -- a board of ``nodes_per_domain`` nodes --
arranged in a wrap-around 2D or 3D grid.  Unlike CLOS, distance is *not*
uniform: hop distance between vertices is the wrap-around Manhattan
distance, so locality is graded and the tightest q-vertex neighbourhood (a
sub-box) matters.  The fabric states hop counts only, no link bandwidth.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.topo.fabric import BaseFabric, register_fabric


@register_fabric("torus")
class TorusFabric(BaseFabric):
    """Wrap-around grid of domains.

    ``dims`` is the grid shape (2 or 3 axes); ``nodes_per_domain`` is the
    node count of every vertex (scalar) or per-vertex counts in row-major
    vertex order (sequence of length ``prod(dims)``).
    """

    kind = "torus"

    def __init__(self, dims: Sequence[int], nodes_per_domain: "int | Sequence[int]" = 8):
        dims = tuple(int(d) for d in dims)
        if len(dims) not in (2, 3) or any(d < 1 for d in dims):
            raise ValueError(f"dims must be 2 or 3 positive axes, got {dims}")
        n_vertices = int(np.prod(dims))
        if isinstance(nodes_per_domain, int):
            counts = [nodes_per_domain] * n_vertices
        else:
            counts = list(nodes_per_domain)
            if len(counts) != n_vertices:
                raise ValueError(
                    f"nodes_per_domain has {len(counts)} entries, "
                    f"grid {dims} has {n_vertices} vertices"
                )
        super().__init__(counts)
        self.dims = dims
        # Vertex id <-> grid coordinate, row-major (id order is the
        # lexicographic walk, so contiguous id ranges are grid rows).
        self._vertex_coords = np.stack(
            np.unravel_index(np.arange(n_vertices), dims), axis=1
        )

    # ------------------------------------------------------------- structure
    def domain_coords(self, domain: int) -> tuple[int, ...]:
        return tuple(int(c) for c in self._vertex_coords[domain])

    def coords(self, node_id: int) -> tuple[int, ...]:
        """Grid coordinate of the node's vertex + slot within the vertex."""
        d = int(self.domain_index()[node_id])
        slot = node_id - self.domain_nodes(d)[0]
        return self.domain_coords(d) + (slot,)

    # ------------------------------------------------------------- distances
    def domain_distance(self, a: int, b: int) -> int:
        ca, cb = self._vertex_coords[a], self._vertex_coords[b]
        total = 0
        for axis, size in enumerate(self.dims):
            delta = abs(int(ca[axis]) - int(cb[axis]))
            total += min(delta, size - delta)  # wrap-around link
        return total

    def diameter(self) -> int:
        return sum(d // 2 for d in self.dims)

    # ------------------------------------------------------------- bisection
    def partition(self, domains: Sequence[int]) -> tuple[list[int], list[int]]:
        """Split along the axis with the largest coordinate extent, keeping
        each half a contiguous slab (minimizes wrap-around cut links)."""
        ds = list(domains)
        if len(ds) < 2:
            return ds, []
        coords = self._vertex_coords[ds]
        extents = coords.max(axis=0) - coords.min(axis=0)
        axis = int(np.argmax(extents))
        order = sorted(ds, key=lambda d: (int(self._vertex_coords[d][axis]), d))
        half = len(order) // 2
        return order[:half], order[half:]
