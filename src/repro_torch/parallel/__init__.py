"""The parallelism layer: sharding rules and DTensor layouts
(:mod:`.sharding`), compressed collectives (:mod:`.collectives`) and the
GPipe pipeline (:mod:`.pipeline`)."""

from repro_torch.parallel.sharding import (
    activate,
    active_mesh,
    default_rules,
    lshard,
    opt_shardings,
    param_shardings,
    param_spec,
    resolve_spec,
)

__all__ = [
    "activate", "active_mesh", "default_rules", "lshard", "opt_shardings",
    "param_shardings", "param_spec", "resolve_spec",
]
