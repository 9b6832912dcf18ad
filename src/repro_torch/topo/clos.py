"""Three-tier CLOS fabric: the paper's production interconnect (§2, Fig. 2b).

Nodes -> leaf switches (one per rack) -> spine switches (one *minipod* per
spine group) -> core switches.  Domains are minipods.  The fabric has full
bisection bandwidth at the core tier, so every pair of distinct minipods is
equidistant: traffic goes leaf -> spine -> core -> spine -> leaf no matter
which pods it connects.  That uniformity is why the paper can characterize
degradation purely as a function of the *number* of minipods spanned
(Fig. 4b/4c) -- the CLOS network model keeps that calibration.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.topo.fabric import BaseFabric, register_fabric

#: hop distance between two distinct minipods (leaf/spine/core tier
#: crossings are symmetric; any inter-pod path transits the core once).
CROSS_POD_DISTANCE = 2


@register_fabric("clos")
class ClosFabric(BaseFabric):
    """The legacy 3-tier CLOS/minipod hierarchy, extracted verbatim from
    ``core/topology.py``: per-minipod node counts plus racks of
    ``nodes_per_rack`` retained for rank ordering."""

    kind = "clos"

    def __init__(self, nodes_per_minipod: Sequence[int], nodes_per_rack: int = 8):
        super().__init__(nodes_per_minipod)
        if nodes_per_rack < 1:
            raise ValueError(f"nodes_per_rack must be >= 1, got {nodes_per_rack}")
        self.nodes_per_rack = nodes_per_rack

    def coords(self, node_id: int) -> tuple[int, int, int]:
        """(minipod, rack, slot-in-rack)."""
        d = int(self.domain_index()[node_id])
        offset = node_id - self.domain_nodes(d)[0]
        return (d, offset // self.nodes_per_rack, offset % self.nodes_per_rack)

    def rack_of(self, node_id: int) -> int:
        return self.coords(node_id)[1]

    def domain_distance(self, a: int, b: int) -> int:
        return 0 if a == b else CROSS_POD_DISTANCE

    def diameter(self) -> int:
        return 0 if self.n_domains <= 1 else CROSS_POD_DISTANCE

    def distance_at_spread(self, spread: int) -> int:
        # All pods equidistant: any multi-pod set has the same diameter.
        return 0 if spread <= 1 or self.n_domains <= 1 else CROSS_POD_DISTANCE
