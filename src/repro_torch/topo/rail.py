"""Rail-only fabric (arXiv:2307.12169).

A rail-optimized GPU cluster removes the CLOS core/spine layers: GPU ``i``
of every node in an HB-domain group connects to rail switch ``i``, so the
group's nodes reach each other in one switch hop on every rail, while
traffic *between* rail groups has no dedicated switching layer at all --
it must be forwarded through GPUs (NVLink hop + double NIC transit).

Domains are rail groups.  Intra-group distance is 0 (one rail-switch hop
is the fabric's locality unit); cross-group distance models the
forwarding detour and is deliberately larger than a CLOS core transit,
which is what makes the spread objective *more* valuable here: a group
that straddles rails pays far more than one that straddles minipods.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.topo.fabric import BaseFabric, register_fabric

#: hop distance between distinct rail groups: NIC -> rail switch -> GPU
#: forward (NVLink) -> NIC -> rail switch -> NIC, modeled as 3 hops vs the
#: CLOS core transit's 2.
CROSS_RAIL_DISTANCE = 3


@register_fabric("rail-only")
class RailOnlyFabric(BaseFabric):
    """Rail-only cluster: domains are rail groups of ``rail_width``-node
    HB domains sharing a set of rail switches."""

    kind = "rail-only"

    def __init__(self, nodes_per_group: Sequence[int], rails: int = 8):
        super().__init__(nodes_per_group)
        if rails < 1:
            raise ValueError(f"rails must be >= 1, got {rails}")
        self.rails = rails

    def coords(self, node_id: int) -> tuple[int, int]:
        """(rail group, slot within group)."""
        return super().coords(node_id)

    def domain_distance(self, a: int, b: int) -> int:
        return 0 if a == b else CROSS_RAIL_DISTANCE

    def diameter(self) -> int:
        return 0 if self.n_domains <= 1 else CROSS_RAIL_DISTANCE

    def distance_at_spread(self, spread: int) -> int:
        return 0 if spread <= 1 or self.n_domains <= 1 else CROSS_RAIL_DISTANCE
