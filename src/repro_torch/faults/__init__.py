"""Correlated fault injection + elastic repair (DESIGN.md §11).

The subsystem has four parts:

* :mod:`repro_torch.faults.model`      -- seeded, reproducible fault traces
  (per-node MTBF, fabric-correlated domain outages, stragglers,
  transient-vs-permanent with return-to-service);
* :mod:`repro_torch.faults.repair`     -- the elastic repair escalation ladder
  behind the ``Scheduler`` contract (``get_scheduler("elastic")``), plus
  the always-full-re-solve and never-repair baselines;
* :mod:`repro_torch.faults.accounting` -- goodput / effective-training-time
  accounting over the ladder's modeled costs;
* :mod:`repro_torch.faults.driver`     -- the simulator-side orchestrator
  (``TraceSimulator.run(faults=...)``).

The port's copy of the reference's ``faults`` package, numpy only: the same
seed gives the same trace (:func:`trace_digest`) and the same replay.
Importing it registers ``"elastic"`` in the port's scheduler registry
(:mod:`repro_torch.core.scheduler`), never in the reference's.
"""

from repro_torch.faults.accounting import GoodputStats, GoodputTracker
from repro_torch.faults.driver import FaultDriver
from repro_torch.faults.model import (
    FaultEvent,
    FaultModel,
    FaultModelConfig,
    trace_digest,
)
from repro_torch.faults.repair import (
    TIERS,
    BoundRepair,
    ElasticRepairPolicy,
    FullResolveRepair,
    NeverRepair,
    RepairCosts,
    RepairOutcome,
    get_repair_policy,
)

__all__ = [
    "BoundRepair",
    "ElasticRepairPolicy",
    "FaultDriver",
    "FaultEvent",
    "FaultModel",
    "FaultModelConfig",
    "FullResolveRepair",
    "GoodputStats",
    "GoodputTracker",
    "NeverRepair",
    "RepairCosts",
    "RepairOutcome",
    "TIERS",
    "get_repair_policy",
    "trace_digest",
]
