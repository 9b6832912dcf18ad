"""repro_torch.serve: continuous-batching inference on the port's kernels.

* :mod:`repro_torch.serve.kv_cache`  -- paged/blocked KV cache: fixed-size
  pages, free-list allocator, per-sequence block tables
* :mod:`repro_torch.serve.request`   -- GenerationRequest / GenerationResult
* :mod:`repro_torch.serve.engine`    -- continuous-batching engine (mid-flight
  admission, prefill + batched decode, page recycling)
* :mod:`repro_torch.serve.loadgen`   -- seeded Poisson load generator +
  latency / throughput report
* :mod:`repro_torch.serve.placement` -- topology-aware replica placement via
  the unified Scheduler registry (:mod:`repro_torch.core`)
"""

from repro_torch.serve.engine import EngineConfig, EngineStats, ServeEngine
from repro_torch.serve.kv_cache import OutOfPages, PageAllocator, PagedCacheConfig, PagedKVCache
from repro_torch.serve.loadgen import (
    LengthMixture,
    LoadGenConfig,
    ServeReport,
    generate_requests,
    run_benchmark,
)
from repro_torch.serve.placement import ReplicaPlacement, ReplicaSet, ReplicaSpec, place_replicas
from repro_torch.serve.request import GenerationRequest, GenerationResult

__all__ = [
    "EngineConfig", "EngineStats", "ServeEngine",
    "OutOfPages", "PageAllocator", "PagedCacheConfig", "PagedKVCache",
    "LengthMixture", "LoadGenConfig", "ServeReport",
    "generate_requests", "run_benchmark",
    "ReplicaPlacement", "ReplicaSet", "ReplicaSpec", "place_replicas",
    "GenerationRequest", "GenerationResult",
]
