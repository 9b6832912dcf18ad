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
* :mod:`repro_torch.core.rank_assign`  -- placement -> device permutation

For the same inputs every function gives the reference's output bit for bit
(wall-clock fields aside).  Not ported yet (ROADMAP.md queue A item 5(b)):
the queue policy (Algorithm 1), the JCT predictor, the network model, the
trace-driven simulator, characterization and the failure manager.

The scheduler registry is the port's own: a policy registered here is not
seen by the reference's ``register_scheduler``, nor the other way round.
"""

from repro_torch.core.affinity import CharacterizationDB, CharRecord
from repro_torch.core.baselines import ALL_BASELINES, best_fit, gpu_packing, random_fit, topo_aware
from repro_torch.core.comm_matrix import (
    CommMatrix,
    JobSpec,
    ModelSpec,
    build_comm_matrix,
    dp_volume_bytes,
    ep_volume_bytes,
    pp_volume_bytes,
)
from repro_torch.core.hierarchical import HierarchicalScheduler
from repro_torch.core.mip import Infeasible, MipResult, schedule_mip
from repro_torch.core.placement_cache import CacheStats, PlacementCache
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
from repro_torch.core.spread import Placement, max_hop_diameters, max_spreads, weighted_spread
from repro_torch.core.topology import Cluster, Domain, Minipod, Node
from repro_torch.topo import Fabric, get_fabric, list_fabrics, register_fabric

__all__ = [name for name in dir() if not name.startswith("_")]
