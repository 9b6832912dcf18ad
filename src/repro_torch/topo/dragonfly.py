"""Dragonfly fabric (survey arXiv:2407.20018 §3.2).

Routers are arranged in *groups*: every router pair inside a group is
directly connected (full local mesh), and every group pair is connected by
at least one global link (full inter-group mesh at the group level).
Minimal routing is therefore at most local -> global -> local: one hop
inside a group, three hops between groups.

Domains are routers (each hosting ``nodes_per_router`` nodes), so the
spread metric sees both levels of the hierarchy: consolidating a
communication group onto one router costs 0, spilling across routers of
the same dragonfly group costs 1 hop, and spilling across groups costs
the 3-hop global detour -- the graded locality that distinguishes
dragonfly from the uniform CLOS core.
"""

from __future__ import annotations

from repro_torch.topo.fabric import BaseFabric, register_fabric

#: minimal-route hop counts.
INTRA_GROUP_DISTANCE = 1   # direct local link between routers of a group
INTER_GROUP_DISTANCE = 3   # local -> global -> local


@register_fabric("dragonfly")
class DragonflyFabric(BaseFabric):
    """Dragonfly: ``n_groups`` groups x ``routers_per_group`` routers x
    ``nodes_per_router`` nodes.  Router (= domain) ids are group-major."""

    kind = "dragonfly"

    def __init__(
        self,
        n_groups: int,
        routers_per_group: int = 4,
        nodes_per_router=8,
    ):
        """``nodes_per_router`` is a scalar (regular fabric) or a list of
        length ``n_groups * routers_per_group`` (per-router capacities, for
        capacity-matched benchmark comparisons)."""
        if n_groups < 1 or routers_per_group < 1:
            raise ValueError(
                f"need positive group/router counts, got "
                f"{n_groups}x{routers_per_group}"
            )
        n_routers = n_groups * routers_per_group
        if isinstance(nodes_per_router, int):
            caps = [nodes_per_router] * n_routers
        else:
            caps = [int(c) for c in nodes_per_router]
            if len(caps) != n_routers:
                raise ValueError(
                    f"nodes_per_router list must have {n_routers} entries "
                    f"(= n_groups * routers_per_group), got {len(caps)}"
                )
        super().__init__(caps)
        self.n_groups = n_groups
        self.routers_per_group = routers_per_group

    # ------------------------------------------------------------- structure
    def group_of(self, domain: int) -> int:
        return domain // self.routers_per_group

    def coords(self, node_id: int) -> tuple[int, int, int]:
        """(group, router within group, slot within router)."""
        d = int(self.domain_index()[node_id])
        slot = node_id - self.domain_nodes(d)[0]
        return (self.group_of(d), d % self.routers_per_group, slot)

    # ------------------------------------------------------------- distances
    def domain_distance(self, a: int, b: int) -> int:
        if a == b:
            return 0
        if self.group_of(a) == self.group_of(b):
            return INTRA_GROUP_DISTANCE
        return INTER_GROUP_DISTANCE

    def diameter(self) -> int:
        if self.n_groups > 1:
            return INTER_GROUP_DISTANCE
        return INTRA_GROUP_DISTANCE if self.routers_per_group > 1 else 0

    def distance_at_spread(self, spread: int) -> int:
        if spread <= 1 or self.n_domains <= 1:
            return 0
        if spread <= self.routers_per_group:
            return INTRA_GROUP_DISTANCE  # fits one group's local mesh
        return INTER_GROUP_DISTANCE

    # ------------------------------------------------------------- bisection
    def partition(self, domains):
        """Split at a group boundary when possible (group-major ids make
        the id-order split already group-coherent)."""
        ds = sorted(domains)
        half = len(ds) // 2
        return ds[:half], ds[half:]
