"""The paper's full flow, end to end:

  1. a CLOS cluster (4 minipods of 2 nodes) + an LPJ spec (64 GPUs, TP=4, PP=2)
  2. communication matrix (Eq. 1) + affinity lookup (characterization DB)
  3. Arnold's MILP placement (Eq. 4-10) vs a naive packing baseline
  4. placement -> logical-rank order -> the (8, 8) rank grid of the mesh
  5. verify the grid's communication-group spread dropped (Eq. 3 on the mesh)
  6. run meshed train steps on an Arnold-ordered mesh over the world given:
     the job's first GPUs in Arnold's logical order, 4 gloo ranks as a (2, 2)
     mesh on the host, a world of one (1, 1) on the card

Steps 1-5 run on the host for the whole 64-GPU job; step 6 trains on the
ranks this machine has.  Run::

    PYTHONPATH=src python -m repro_torch.examples.schedule_and_launch [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import (
    CharacterizationDB,
    Cluster,
    JobSpec,
    ModelSpec,
    ScheduleRequest,
    build_comm_matrix,
    get_scheduler,
    list_schedulers,
)
from repro_torch.core.rank_assign import device_permutation
from repro_torch.launch.mesh import arnold_rank_grid, grid_group_spread, process_group, spawn

DEVICES_PER_POD = 16   # rank-block convention: contiguous id blocks = minipods
AXES = ("data", "model")
STEPS = 3


def sharded_steps(rank: int, grid: np.ndarray, device: str) -> list[float]:
    """``STEPS`` meshed train steps of reduced minicpm-2b on a DeviceMesh of
    ``grid``'s ranks; the losses (the same on every rank)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.data import SyntheticDataset
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.train import make_train_step

    if device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    cfg = get_config("minicpm-2b").reduced()
    model = build_model(cfg, ModelOptions(param_dtype="float32", compute_dtype="float32",
                                          remat=False), device=device)
    mesh = DeviceMesh(torch.device(device).type, torch.as_tensor(grid), mesh_dim_names=AXES)
    ds = SyntheticDataset(cfg.vocab, seq_len=64, global_batch=16)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    state = init_opt_state(params)
    step = make_train_step(model, AdamWConfig(lr=1e-3), mesh=mesh)
    losses = []
    for i in range(STEPS):
        params, state, metrics = step(params, state, ds.batch(i))
        losses.append(float(metrics["loss"]))
        if rank == 0:
            print(f"sharded step {i}: loss={losses[-1]:.4f}", flush=True)
    return losses


def main(device: str | None = None) -> dict:
    device = device or "cuda"
    # -- 1. cluster + job ----------------------------------------------------
    cluster = Cluster.uniform(4, 2)        # 4 minipods x 2 nodes = 64 GPUs
    arch = get_config("minicpm-2b")
    mspec = ModelSpec(
        name=arch.name, hidden=arch.d_model, layers=arch.n_layers,
        vocab=arch.vocab, seq_len=64, global_batch=16, d_ff=arch.d_ff,
    )
    job = JobSpec(n_gpus=64, tp=4, pp=2, model=mspec)

    # -- 2. comm matrix + affinity -------------------------------------------
    comm = build_comm_matrix(job)
    alpha, beta, unit = CharacterizationDB().affinity_for(comm)
    print(f"comm matrix {comm.shape}; v_d={comm.v_d/2**20:.0f} MiB "
          f"v_p={comm.v_p/2**20:.1f} MiB; affinity alpha={alpha:.2f} unit={unit}")

    # -- 3. MILP placement vs baseline, via the unified scheduler API --------
    request = ScheduleRequest(comm=comm, cluster=cluster, alpha=alpha,
                              beta=beta, unit=unit)
    print(f"registered schedulers: {list_schedulers()}")
    res = get_scheduler("mip").schedule(request)
    base = get_scheduler("gpu-packing").schedule(request)
    print(f"Arnold spreads (dp, pp): ({res.dp_spread}, {res.pp_spread}) "
          f"[{res.method}, {res.solve_seconds*1e3:.1f} ms]")
    print(f"packing spreads (dp, pp): ({base.dp_spread}, {base.pp_spread})")

    # -- 4./5. the mesh's rank grid from the placement -----------------------
    arnold = arnold_rank_grid(res.placement, job.tp, (8, 8), range(job.n_gpus))
    naive = np.arange(job.n_gpus).reshape(8, 8)
    spreads = {}
    for name, grid in (("arnold", arnold), ("naive", naive)):
        spreads[name] = {axis: grid_group_spread(grid, AXES, axis, DEVICES_PER_POD)
                         for axis in ("model", "data")}
        print(f"{name} mesh: model-axis spread={spreads[name]['model']}, "
              f"data-axis spread={spreads[name]['data']}")

    # -- 6. meshed training steps on the Arnold mesh -------------------------
    # the world's ranks drive the job's first GPUs in Arnold's logical order
    world = 4 if device == "cpu" else 1
    side = int(world ** 0.5)
    physical = np.asarray(device_permutation(res.placement, job.tp)[:world]).reshape(side, side)
    grid = np.searchsorted(np.sort(physical.ravel()), physical)
    print(f"world of {world}: mesh {grid.shape} over GPUs {physical.ravel().tolist()}")
    if world == 1:
        with process_group(device):
            losses = sharded_steps(0, grid, device)
    else:
        losses = spawn(sharded_steps, world, device, args=(grid, device))[0]
    assert all(np.isfinite(losses))
    print("OK: scheduled, placed, and trained on the Arnold-aligned mesh")
    return {"comm_shape": comm.shape, "affinity": (alpha, beta, unit),
            "schedulers": list_schedulers(),
            "mip": {"method": res.method, "spreads": (res.dp_spread, res.pp_spread)},
            "packing": {"method": base.method, "spreads": (base.dp_spread, base.pp_spread)},
            "grid_spreads": spreads, "mesh_gpus": physical.ravel().tolist(), "losses": losses}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
