"""Fault tolerance at the scheduling layer (paper Appendix B + beyond).

The paper notes (Limitations) that on hardware failure the optimal placement
changes, but a full MIP re-solve + migration is too expensive, and suggests
reserving *backup nodes per communication group* that run preemptable jobs
until promoted.  :class:`FailureManager` is the original implementation of
that proposal; it is now a thin compatibility adapter over the full elastic
repair ladder in :mod:`repro_torch.faults.repair` (DESIGN.md §11.2), which adds
the shrink/restart tiers, preemption cascades, and cost modeling.

The adapter keeps the pre-ladder surface -- per-domain ``backups``,
``events`` with kinds ``"backup"``/``"local"``/``"cross-pod"``, and the
same escalation for single independent failures -- but the candidate
search underneath is now fabric-aware: "minipod" means the fabric's
locality domain (a rail on ``rail-only``, a board on ``torus``, ...), and
cross-domain candidates are ordered by fabric hop distance instead of
domain id (on ``clos`` hop distance is uniform, so the legacy order is
unchanged).  New code should use
:class:`repro_torch.faults.ElasticRepairPolicy` directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.mip import Infeasible
from repro_torch.core.spread import Placement, max_spreads
from repro_torch.core.topology import Cluster

#: ladder tier -> legacy event kind.
_LEGACY_KINDS = {"backup": "backup", "domain": "local", "warm": "cross-pod"}


@dataclasses.dataclass
class RepairEvent:
    failed_node: int
    replacement: int
    kind: str           # "backup" | "local" | "cross-pod"
    dp_spread_after: int
    pp_spread_after: int


class FailureManager:
    """Maintains per-domain backup nodes for a running LPJ and repairs the
    placement on node failure / straggling without a full re-solve."""

    def __init__(
        self,
        placement: Placement,
        cluster: Cluster,
        backup_frac: float = 0.05,
        seed: int = 0,
    ):
        from repro_torch.faults.repair import BoundRepair

        self.placement = placement
        self.cluster = cluster
        self.events: list[RepairEvent] = []
        # Backup/domain/warm tiers only: the pre-ladder manager raised
        # Infeasible where the ladder would now shrink or restart.
        self._bound = BoundRepair(
            placement, cluster, backup_frac=backup_frac, max_tier="warm",
        )

    @property
    def backups(self) -> dict[int, list[int]]:
        return self._bound.backups

    @property
    def dead(self) -> set[int]:
        return self._bound.dead

    def backup_count(self) -> int:
        return self._bound.backup_count()

    def _record(self, node_id: int, replacement: int, tier: str) -> RepairEvent:
        dp_s, pp_s = max_spreads(self.placement)
        ev = RepairEvent(
            failed_node=node_id,
            replacement=replacement,
            kind=_LEGACY_KINDS[tier],
            dp_spread_after=dp_s,
            pp_spread_after=pp_s,
        )
        self.events.append(ev)
        return ev

    def on_failure(self, node_id: int) -> RepairEvent:
        """Replace a failed node.  Preference order: (1) same-domain backup
        (spread unchanged), (2) same-domain free node, (3) free node in a
        domain the affected groups already span -- nearest by fabric hop
        distance -- (4) any free node (nearest domain first)."""
        got = self._bound.repair_one(node_id)  # ValueError if not placed
        if got is None:
            raise Infeasible("no free node anywhere to repair the placement")
        tier, repl = got
        return self._record(node_id, repl, tier)

    def on_straggler(self, node_id: int) -> Optional[RepairEvent]:
        """Swap a persistently slow node with a same-domain backup if one
        exists; otherwise leave it (a cross-domain move could cost more than
        the straggler does -- the elastic driver escalates, this adapter
        keeps the pre-ladder backup-only behavior)."""
        outcome = self._bound.on_straggler(node_id, now=0.0, escalate=False)
        if outcome is None:
            return None
        return self._record(node_id, outcome.replacements[0], "backup")
