"""End-to-end training driver: ``python -m repro_torch.launch.train --arch <id>``.

The reference's ``launch/train.py``: config -> model -> synthetic data
pipeline -> AdamW (+schedule) -> fault-tolerant Trainer with
checkpoint-restart, with the reference's flags and rules (``--full`` for the
published config, else ``reduced()``; ``remat`` on with ``--full``; fp32
master weights; compute in fp32 on one device, in bf16 on a sharded run).
Runs on the card unless ``--device cpu`` is given.

``--devices N --mesh-shape dxm`` trains on a ``(data, model)`` DeviceMesh of
``d * m <= N`` ranks through the meshed train step: on ``cpu`` in that many
spawned gloo ranks, on ``cuda`` one rank per GPU (rank r on ``cuda:r``, NCCL;
it needs N visible GPUs, and a world of one runs in this process).
``--arnold`` orders the mesh's ranks by the Arnold placement of the job from
the ``--scheduler`` policy (a registry name or a comma chain, as the
reference's) and prints ``Arnold placement [method]: pods=... spread(data
axis)=...``.  A job is node-granular (8 GPUs a node), so the placement is of
the job rounded up to whole nodes and the mesh takes its first ``d * m`` GPUs
in Arnold's logical order.  Each rank makes its state in the meshed step's
layout (``Trainer._init_state``) and never holds the whole of it; on ``cuda``
each rank prints, after the run, ``rank R on cuda:I: {...}``: the peak of
allocated bytes before step 1 (``init_peak_bytes``, with the bytes of its
state's shards, ``state_bytes``), the peak over the steps and checkpoint
saves (``step_peak_bytes``), and the kernels' launches of each step (``[steps,
{kernel: launches}]`` for each run of steps that launched alike).
"""

import argparse
import json
import math
import os
import sys
import tempfile


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--full", action="store_true",
                    help="use the full published config (default: reduced)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--devices", type=int, default=0,
                    help="devices of a sharded run (0 = single device, no mesh)")
    ap.add_argument("--mesh-shape", default="2x4", help="dataxmodel of the sharded run")
    ap.add_argument("--arnold", action="store_true",
                    help="order the mesh's ranks by the Arnold placement")
    ap.add_argument("--scheduler", default=None,
                    help="placement policy for --arnold (default mip): a registry name (see "
                         "repro_torch.core.list_schedulers()) or a comma-separated "
                         "fallback chain, e.g. 'mip,topo-aware'")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def arnold_job(cfg, args):
    """The reference launcher's job for ``--arnold`` (its cluster, model and
    parallelism), at node granularity: (cluster, job)."""
    from repro_torch.core import Cluster, JobSpec, ModelSpec

    d, m = (int(x) for x in args.mesh_shape.split("x"))
    nodes = args.devices // 8
    cluster = Cluster.uniform(max(2, nodes // 4), 4)
    mspec = ModelSpec(name=cfg.name, hidden=cfg.d_model, layers=cfg.n_layers, vocab=cfg.vocab,
                      seq_len=args.seq_len, global_batch=args.global_batch,
                      d_ff=cfg.d_ff or 4 * cfg.d_model)
    job = JobSpec(n_gpus=8 * math.ceil(d * m / 8), tp=min(m, 8), pp=1, model=mspec)
    return cluster, job


def arnold_plan(cfg, args):
    """(scheduler method, minipods used, physical GPU grid (d, m) in Arnold's
    logical order, spread of its data axis over 32-GPU minipods)."""
    import numpy as np

    from repro_torch.core import CharacterizationDB, ScheduleRequest, build_comm_matrix, get_scheduler
    from repro_torch.core.rank_assign import device_permutation
    from repro_torch.launch.mesh import grid_group_spread

    d, m = (int(x) for x in args.mesh_shape.split("x"))
    cluster, job = arnold_job(cfg, args)
    comm = build_comm_matrix(job)
    alpha, beta, unit = CharacterizationDB().affinity_for(comm)
    res = get_scheduler(args.scheduler).schedule(ScheduleRequest(
        comm=comm, cluster=cluster, alpha=alpha, beta=beta, unit=unit))
    grid = np.asarray(device_permutation(res.placement, job.tp)[: d * m]).reshape(d, m)
    return res.method, res.n_pods_used(), grid, grid_group_spread(grid, ("data", "model"), "data", 32)


def _mesh(cfg, args, device_type: str):
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    d, m = (int(x) for x in args.mesh_shape.split("x"))
    if not args.arnold:
        grid = np.arange(d * m).reshape(d, m)
        return DeviceMesh(device_type, torch.as_tensor(grid), mesh_dim_names=("data", "model"))
    plan = [arnold_plan(cfg, args) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(plan, src=0)
    method, pods, physical, spread = plan[0]
    # rank r drives the r-th of the job's GPUs in physical order
    ranks = np.searchsorted(np.sort(physical.ravel()), physical)
    if dist.get_rank() == 0:
        print(f"Arnold placement [{method}]: pods={pods} spread(data axis)={spread}", flush=True)
    return DeviceMesh(device_type, torch.as_tensor(ranks), mesh_dim_names=("data", "model"))


def _measured(step_fn, report: dict):
    """``step_fn`` recording into ``report`` what ``_train`` prints of a rank
    on ``cuda``: on its first call the allocator's peak so far (the state's
    init or restore) and the local bytes of that state, then the kernels'
    launches of every call; the allocator's peak is reset before step 1."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.optim.adamw import tree_leaves

    def local_bytes(tree) -> int:
        return sum((t.to_local() if ops.is_dtensor(t) else t).nbytes
                   for t in tree_leaves(tree) if isinstance(t, torch.Tensor))

    report["launches"] = []   # [steps, launches of each of them], a run of equal steps each

    def step(params, opt_state, batch):
        if "init_peak_bytes" not in report:
            torch.cuda.synchronize()
            report["init_peak_bytes"] = torch.cuda.max_memory_allocated()
            report["state_bytes"] = local_bytes([params, opt_state])
            torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        out = step_fn(params, opt_state, batch)
        after = ops.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        if report["launches"] and report["launches"][-1][1] == launches:
            report["launches"][-1][0] += 1
        else:
            report["launches"].append([1, launches])
        return out

    step.state_shardings = step_fn.state_shardings
    return step


def _train(rank, args) -> int:
    """Train on this process: one device when ``rank`` is None, else rank
    ``rank`` of the started process group on the mesh.  Returns the exit
    code: 0 when the last logged loss is below the first."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticDataset
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.optim import AdamWConfig, get_schedule
    from repro_torch.train import Trainer, TrainerConfig, make_train_step

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    meshed = rank is not None
    device = args.device
    if meshed and args.device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    opts = ModelOptions(param_dtype="float32",
                        compute_dtype="bfloat16" if args.devices else "float32",
                        remat=bool(args.full))
    model = build_model(cfg, opts, device=device)

    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = ((args.global_batch, cfg.n_patches, cfg.d_model), "float32")
    if cfg.family == "audio":
        extra["frames"] = ((args.global_batch, 24, cfg.d_model), "float32")
    ds = SyntheticDataset(cfg.vocab, args.seq_len, args.global_batch, seed=args.seed,
                          extra_specs=extra)
    schedule = get_schedule(cfg.lr_schedule, args.lr, warmup_steps=max(1, args.steps // 20),
                            total_steps=args.steps)
    opt = AdamWConfig(lr=schedule)
    talk = not meshed or rank == 0

    trainer = Trainer(
        model, ds, opt, ckpt_dir=args.ckpt_dir,
        cfg=TrainerConfig(
            total_steps=args.steps, ckpt_every=args.ckpt_every,
            log_every=args.log_every, microbatches=args.microbatches,
            seed=args.seed,
        ),
        on_step=(lambda h: print(
            f"step {h['step']:5d}  loss {h['loss']:.4f}  "
            f"gnorm {h['grad_norm']:.3f}  {h['step_time']*1e3:.0f} ms",
            flush=True,
        )) if talk else None,
    )
    report: dict = {}
    if meshed:
        mesh = _mesh(cfg, args, torch.device(device).type)
        trainer.step_fn = make_train_step(model, opt, mesh=mesh, microbatches=args.microbatches)
        if model.device.type == "cuda":
            trainer.step_fn = _measured(trainer.step_fn, report)
    trainer.run()
    if report:
        torch.cuda.synchronize()
        report["step_peak_bytes"] = torch.cuda.max_memory_allocated()
        sys.stdout.flush()   # one write: the ranks share the launcher's output
        os.write(sys.stdout.fileno(), f"rank {rank} on {device}: {json.dumps(report)}\n".encode())

    losses = trainer.losses()
    if not losses:
        if talk:
            print(f"nothing to train: the checkpoint in {args.ckpt_dir} is at step "
                  f"{trainer.ckpt.latest_step()}, --steps is {args.steps}")
        return 0
    if talk:
        print(f"done: first logged loss {losses[0]:.4f} -> last {losses[-1]:.4f}", flush=True)
    return 0 if losses[-1] < losses[0] else 1


def main(argv=None) -> int:
    args = _parse(argv)
    if args.scheduler is not None and not args.arnold:
        raise ValueError("--scheduler picks the placement of --arnold: it needs --arnold and "
                         "--devices")
    args.scheduler = args.scheduler or "mip"
    if not args.devices:
        if args.arnold:
            raise ValueError("--arnold orders a mesh: it needs --devices")
        return _train(None, args)

    import torch

    from repro_torch.launch.mesh import process_group, spawn

    d, m = (int(x) for x in args.mesh_shape.split("x"))
    if d * m > args.devices:
        raise ValueError(f"mesh {args.mesh_shape} needs {d * m} devices, --devices is {args.devices}")
    if args.device == "cuda" and torch.cuda.device_count() < args.devices:
        raise RuntimeError(f"--devices {args.devices} needs {args.devices} visible GPUs, this "
                           f"machine has {torch.cuda.device_count()}")
    if d * m == 1:
        with process_group(args.device):
            return _train(0, args)
    return spawn(_train, d * m, args.device, (args,))[0]


if __name__ == "__main__":
    sys.exit(main())
