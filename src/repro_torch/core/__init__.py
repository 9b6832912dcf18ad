"""Arnold: topology-aware communication alignment for LLM pre-training.

The port's copy of the reference's scheduling core (numpy and scipy, as in
the reference and the paper), the placement path from workload to rank order:

* :mod:`repro_torch.core.topology`     -- cluster model over a pluggable fabric
  (:mod:`repro_torch.topo`: clos / rail-only / torus / dragonfly)
* :mod:`repro_torch.core.comm_matrix`  -- workload representation (Eq. 1, App. C)
* :mod:`repro_torch.core.spread`       -- spread metric + Eq. 2 objective
* :mod:`repro_torch.core.mip`          -- the MILP scheduler (Eq. 4-10)
* :mod:`repro_torch.core.baselines`    -- best-fit / random-fit / gpu-packing / topo-aware
* :mod:`repro_torch.core.scheduler`    -- unified Scheduler API: request/result
  contract, policy registry, fallback chains
* :mod:`repro_torch.core.hierarchical` -- "hier" scale tier: block decomposition,
  warm-start re-solve, placement cache
* :mod:`repro_torch.core.placement_cache` -- counts-matrix cache for recurring
  job shapes
* :mod:`repro_torch.core.affinity`     -- characterization DB -> (alpha, beta)
* :mod:`repro_torch.core.queue`        -- Algorithm 1 reservation policy
* :mod:`repro_torch.core.jct`          -- GBM job-completion-time predictor
* :mod:`repro_torch.core.simulator`    -- trace-driven simulator
* :mod:`repro_torch.core.netmodel`     -- calibrated BusBw / step-time model
* :mod:`repro_torch.core.characterize` -- automated pre-characterization
* :mod:`repro_torch.core.failures`     -- backup-node repair, straggler mitigation
  (compat adapter over the :mod:`repro_torch.faults` elastic repair ladder)
* :mod:`repro_torch.core.rank_assign`  -- placement -> device permutation

For the same inputs every function gives the reference's output bit for bit
(wall-clock fields aside): the same placements, the same fitted trees, the
same replayed time series and the same fault-trace digests.

The scheduler registry is the port's own: a policy registered here is not
seen by the reference's ``register_scheduler``, nor the other way round.
Importing :mod:`repro_torch.faults` adds ``"elastic"`` to it.  The
per-fabric network-model registry is the port's own as well.
"""

from repro_torch.core.affinity import CharacterizationDB, CharRecord
from repro_torch.core.baselines import ALL_BASELINES, best_fit, gpu_packing, random_fit, topo_aware
from repro_torch.core.characterize import characterize, characterize_sweep
from repro_torch.core.comm_matrix import (
    CommMatrix,
    JobSpec,
    ModelSpec,
    build_comm_matrix,
    dp_volume_bytes,
    ep_volume_bytes,
    pp_volume_bytes,
)
from repro_torch.core.failures import FailureManager, RepairEvent
from repro_torch.core.hierarchical import HierarchicalScheduler
from repro_torch.core.jct import JCTPredictor, synthetic_trace
from repro_torch.core.mip import Infeasible, MipResult, schedule_mip
from repro_torch.core.placement_cache import CacheStats, PlacementCache
from repro_torch.core.netmodel import (
    ClosNetModel,
    DragonflyNetModel,
    FabricNetModel,
    NetModel,
    NetModelConfig,
    RailOnlyNetModel,
    TorusNetModel,
    fabric_net_model,
    register_fabric_net_model,
    simulate_step_time,
)
from repro_torch.core.queue import Job, QueuePolicy
from repro_torch.core.rank_assign import device_permutation, logical_to_physical_gpus
from repro_torch.core.scheduler import (
    FallbackChain,
    ScheduleRequest,
    ScheduleResult,
    Scheduler,
    get_scheduler,
    list_schedulers,
    register_scheduler,
)
from repro_torch.core.simulator import TraceSimulator, poisson_trace, throughput_of_placement
from repro_torch.core.spread import Placement, max_hop_diameters, max_spreads, weighted_spread
from repro_torch.core.topology import Cluster, Domain, Minipod, Node
from repro_torch.topo import Fabric, get_fabric, list_fabrics, register_fabric

__all__ = [name for name in dir() if not name.startswith("_")]
