"""repro_torch.topo: pluggable fabric subsystem (DESIGN.md §9), the
reference's ``topo`` package for the port, numpy only.

* :mod:`repro_torch.topo.fabric`    -- Fabric protocol + registry
* :mod:`repro_torch.topo.clos`      -- 3-tier CLOS/minipod hierarchy (the paper's)
* :mod:`repro_torch.topo.rail`      -- rail-only fabric (arXiv:2307.12169)
* :mod:`repro_torch.topo.torus`     -- 2D/3D wrap-around torus
* :mod:`repro_torch.topo.dragonfly` -- dragonfly groups (arXiv:2407.20018 §3.2)

The registry is the port's own: a fabric registered here is not seen by the
reference's ``register_fabric``, nor the other way round.
"""

from repro_torch.topo.fabric import (
    BaseFabric,
    Fabric,
    fabric_class,
    get_fabric,
    list_fabrics,
    register_fabric,
)
from repro_torch.topo.clos import ClosFabric
from repro_torch.topo.dragonfly import DragonflyFabric
from repro_torch.topo.rail import RailOnlyFabric
from repro_torch.topo.torus import TorusFabric

import numpy as np


def comparable_fabric(kind: str, capacities, **kwargs) -> Fabric:
    """Build a fabric of family ``kind`` with the same total node count and
    (as closely as the family's structure allows) the same per-domain
    capacities as ``capacities`` -- the apples-to-apples constructor the
    cross-fabric benchmarks use.

    ``clos`` and ``rail-only`` take the capacities verbatim.  ``torus``
    factors the domain count into the most-square 2D grid (padding with
    empty-free domains is avoided by requiring an exact factorization of
    ``len(capacities)``; pass ``dims=...`` to override).  ``dragonfly``
    groups the domains into the most-square (groups x routers) split,
    carrying the per-router capacities verbatim.
    """
    caps = [int(c) for c in capacities]
    kind_c = kind.strip().lower().replace("_", "-")
    if kind_c in ("clos", "fat-tree", "minipod"):
        return ClosFabric(caps, **kwargs)
    if kind_c in ("rail-only", "rail", "railonly"):
        return RailOnlyFabric(caps, **kwargs)
    if kind_c == "torus":
        dims = kwargs.pop("dims", None) or _most_square(len(caps))
        return TorusFabric(dims, nodes_per_domain=caps, **kwargs)
    if kind_c == "dragonfly":
        groups, routers = _most_square(len(caps))
        return DragonflyFabric(
            n_groups=groups, routers_per_group=routers,
            nodes_per_router=caps, **kwargs,
        )
    raise KeyError(f"unknown fabric {kind!r}; available: {list_fabrics()}")


def _most_square(n: int) -> tuple[int, int]:
    """(a, b) with a*b == n and a <= b, a as large as possible."""
    a = int(np.sqrt(n))
    while n % a:
        a -= 1
    return (a, n // a)
