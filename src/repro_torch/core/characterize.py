"""Automated pre-characterization (paper §4, Fig. 5a -> §5.2 database).

The paper characterizes each (model config, GPU type) by running the job
under DP-aligned / PP-aligned / naive placements and recording the relative
improvements ``(j_dp, j_pp)``, which the online scheduler later converts to
affinity ``alpha = j_dp/(j_dp+j_pp)``.  This module automates that loop in
software: the three placements are constructed exactly as in Figure 3
(DP-aligned = each DP group inside one minipod; PP-aligned = each PP group
inside one minipod; naive = balanced random), their throughput comes from
the calibrated step-time model, and the result is a ready-to-insert
:class:`CharRecord` -- so a new cluster/GPU type can be characterized by
sweeping model configs instead of hand-running NCCL tests.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.affinity import CharRecord
from repro_torch.core.comm_matrix import JobSpec, build_comm_matrix
from repro_torch.core.netmodel import NetModel
from repro_torch.core.scheduler import ScheduleRequest, get_scheduler
from repro_torch.core.simulator import throughput_of_placement
from repro_torch.core.topology import Cluster


def characterize(
    job: JobSpec,
    cluster_factory: Callable[[], Cluster],
    net: Optional[NetModel] = None,
    steps: int = 5,
    **step_kw,
) -> CharRecord:
    """Run the Fig. 5a experiment for one job; return the DB record."""
    net = net or NetModel()
    comm = build_comm_matrix(job)

    mip = get_scheduler("mip")
    # Figure 3b: DP-aligned -- each DP group (column) consolidated.
    dp_aligned = mip.schedule(ScheduleRequest(
        comm=comm, cluster=cluster_factory(), alpha=0.0, beta=1.0, unit="dp",
    )).placement
    # Figure 3c: PP-aligned -- each PP group (row) consolidated.
    pp_aligned = mip.schedule(ScheduleRequest(
        comm=comm, cluster=cluster_factory(), alpha=0.0, beta=1.0, unit="pp",
    )).placement
    # Naive: balanced random (the misaligned Figure 3a situation).
    naive = get_scheduler("random-fit").schedule(ScheduleRequest(
        comm=comm, cluster=cluster_factory(), seed=0,
    )).placement

    t_dp = throughput_of_placement(dp_aligned, net=net, steps=steps, **step_kw)
    t_pp = throughput_of_placement(pp_aligned, net=net, steps=steps, **step_kw)
    t_nv = throughput_of_placement(naive, net=net, steps=steps, **step_kw)

    j_dp = max(0.0, 100.0 * (t_dp["tokens_per_s"] / t_nv["tokens_per_s"] - 1.0))
    j_pp = max(0.0, 100.0 * (t_pp["tokens_per_s"] / t_nv["tokens_per_s"] - 1.0))
    r1, r2 = comm.ratios()
    return CharRecord(
        gpu_type=job.gpu_type,
        model_name=job.model.name,
        r1=r1,
        r2=r2,
        j_dp=j_dp,
        j_pp=j_pp,
        unit="dp" if j_dp > j_pp else "pp",
    )


def characterize_sweep(
    jobs: list[JobSpec],
    cluster_factory: Callable[[], Cluster],
    net: Optional[NetModel] = None,
) -> list[CharRecord]:
    """Pre-characterize a family of jobs (the paper's 'LPJs are scheduled in
    advance and pre-characterized' workflow)."""
    return [characterize(j, cluster_factory, net=net) for j in jobs]
