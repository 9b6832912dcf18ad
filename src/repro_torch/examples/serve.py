"""Continuous-batching serving on a reduced glm4-9b (GQA kv=2): replicas
placed through the scheduler registry on a topology-aware policy, then a
seeded Poisson load served by the paged-KV engine (``repro_torch.serve``),
reporting tokens/s and latency percentiles::

    PYTHONPATH=src python -m repro_torch.examples.serve [--device cpu]
"""

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import Cluster
from repro_torch.models import ModelOptions, build_model
from repro_torch.serve import (
    EngineConfig,
    LoadGenConfig,
    ReplicaSpec,
    ServeEngine,
    generate_requests,
    place_replicas,
    run_benchmark,
)
from repro_torch.serve.placement import serving_model_spec


def main(device: str | None = None) -> dict:
    cfg = get_config("glm4-9b").reduced()

    # 1) serving replicas are placed like any other communication-group
    #    workload: through get_scheduler(...) with graceful fallback
    cluster = Cluster.uniform(4, 4)
    replicas = place_replicas(
        cluster, 2,
        ReplicaSpec(model=serving_model_spec(cfg), tp=8, pp=2, n_gpus=16),
        scheduler="mip,topo-aware",
    )
    placed = []
    for p in replicas.placements:
        print(f"replica {p.replica_id}: nodes {p.node_ids} via {p.method} "
              f"(pp_spread={p.result.pp_spread})")
        placed.append({"replica_id": p.replica_id, "node_ids": list(p.node_ids),
                       "method": p.method, "pp_spread": p.result.pp_spread})

    # 2) one replica's engine serves a seeded Poisson workload with
    #    mid-flight admission and page recycling
    model = build_model(cfg, ModelOptions(param_dtype="float32", compute_dtype="float32",
                                          remat=False), device=device or "cuda")
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    engine = ServeEngine(model, params, EngineConfig(
        max_batch=8, page_size=16, n_pages=48, max_blocks=4,
    ))
    requests = generate_requests(LoadGenConfig(
        seed=0, n_requests=16, rate_rps=150.0, vocab=cfg.vocab,
    ))
    report = run_benchmark(engine, requests)
    print(report.summary())

    # 3) sanity: everything finished, tokens in range, every page recycled
    results = engine.results
    assert len(results) == len(requests)
    assert all(len(r.tokens) == req.max_new_tokens
               for r, req in zip(results, requests))
    assert all(0 <= t < cfg.vocab for r in results for t in r.tokens)
    engine.cache.allocator.assert_all_free()
    assert engine.cache.allocator.n_free == engine.config.n_pages
    replicas.release()
    assert cluster.n_free == cluster.n_nodes
    print("OK")
    return {"replicas": placed, "completed": report.n_completed,
            "tokens": report.total_tokens}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
