"""Topology-aware serving-replica placement (DESIGN.md §7.4).

Serving replicas are "just another communication-group workload" (survey
arXiv:2407.20018): a replica is a small TP/PP job whose comm matrix flows
through the same unified :mod:`repro_torch.core.scheduler` registry as training
jobs, so serving traffic exercises the topology-aware placement path --
including :class:`FallbackChain` degradation -- with zero scheduler changes.

Replicas are placed sequentially: each replica's nodes are allocated before
the next solve, so replicas never overlap and each one individually
minimizes its own spread (a replica's TP/PP groups are latency-critical; the
replicas themselves share no traffic).  On any :class:`Infeasible` the whole
set rolls back and the error propagates.

The port's copy of the reference's ``serve/placement.py``; it reads the
port's own :class:`repro_torch.configs.ArchConfig`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.comm_matrix import CommMatrix, JobSpec, ModelSpec, build_comm_matrix
from repro_torch.core.mip import Infeasible
from repro_torch.core.scheduler import ScheduleRequest, ScheduleResult, Scheduler, get_scheduler
from repro_torch.core.topology import GPUS_PER_NODE, Cluster


def serving_model_spec(cfg, *, batch: int = 32, seq_len: int = 4096) -> ModelSpec:
    """Map an :class:`ArchConfig` (models layer) to the :class:`ModelSpec`
    the comm-volume model (core layer) understands, at serving shapes."""
    return ModelSpec(
        name=f"{cfg.name}-serve", hidden=cfg.d_model, layers=cfg.n_layers,
        vocab=cfg.vocab, seq_len=seq_len, global_batch=batch, micro_batch=1,
        d_ff=cfg.d_ff, n_experts=cfg.n_experts, top_k=cfg.top_k,
        d_expert=cfg.d_expert,
    )


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """One serving replica: a small TP/PP job (node-granular, like any job)."""

    model: ModelSpec
    tp: int = 8
    pp: int = 1
    n_gpus: int = 8

    def job(self) -> JobSpec:
        return JobSpec(n_gpus=self.n_gpus, tp=self.tp, pp=self.pp, model=self.model)

    def comm(self) -> CommMatrix:
        return build_comm_matrix(self.job())

    @property
    def n_nodes(self) -> int:
        return self.n_gpus // GPUS_PER_NODE


@dataclasses.dataclass
class ReplicaPlacement:
    replica_id: int
    result: ScheduleResult
    node_ids: list[int]

    @property
    def method(self) -> str:
        return self.result.method


class ReplicaSet:
    """Placed replicas holding their nodes until :meth:`release`."""

    def __init__(self, cluster: Cluster, placements: list[ReplicaPlacement]):
        self.cluster = cluster
        self.placements = placements
        self._released = False

    @property
    def n_replicas(self) -> int:
        return len(self.placements)

    def node_ids(self) -> list[int]:
        return [n for p in self.placements for n in p.node_ids]

    def minipods_used(self) -> set[int]:
        return {self.cluster.nodes[n].minipod for n in self.node_ids()}

    def release(self) -> None:
        if self._released:
            return
        self.cluster.release(self.node_ids())
        self._released = True


def place_replicas(
    cluster: Cluster,
    n_replicas: int,
    spec: ReplicaSpec,
    *,
    scheduler: "str | Scheduler" = "mip,topo-aware",
    alpha: float = 0.5,
    time_budget: float = 5.0,
    seed: int = 0,
) -> ReplicaSet:
    """Place ``n_replicas`` copies of ``spec`` via the scheduler registry.

    ``scheduler`` is any registry name, comma chain, or instance --
    the default degrades from the MILP to the topo-aware heuristic exactly
    like training placement does.  Allocated nodes roll back if any replica
    is infeasible.
    """
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
    sched = get_scheduler(scheduler)
    placements: list[ReplicaPlacement] = []
    allocated: list[int] = []
    try:
        for r in range(n_replicas):
            result = sched.schedule(ScheduleRequest(
                comm=spec.comm(), cluster=cluster, alpha=alpha,
                time_budget=time_budget, seed=seed + r,
            ))
            ids = result.placement.node_ids()
            cluster.allocate(ids)
            allocated.extend(ids)
            placements.append(ReplicaPlacement(
                replica_id=r, result=result, node_ids=ids,
            ))
    except Infeasible:
        cluster.release(allocated)
        raise
    return ReplicaSet(cluster, placements)
