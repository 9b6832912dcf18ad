"""The port's Arnold-ordered ``DeviceMesh`` against the reference's JAX mesh.

The port's meshes are built in this process over ``torch.distributed``'s
``fake`` backend (a world of 64 or 256 ranks, no other process); the
reference's runs in a subprocess with 64 fake XLA host devices, since the
test process keeps JAX on one CPU device.  The group spreads of both meshes,
on the same placement, must be equal for both axes, Arnold-ordered and
naive."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro_torch.core as P
from repro_torch.launch import mesh as port_mesh

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def fake_world():
    """A fake default process group of ``world_size`` ranks, this process
    being rank 0; torn down after the test."""
    def init(world_size: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)

    try:
        yield init
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def model(pkg):
    return pkg.ModelSpec(name="m", hidden=1024, layers=8, vocab=5000, seq_len=128,
                         global_batch=64, d_ff=4096)


def mip_placement(pkg, pods, nodes_per_pod, n_gpus, tp, pp, alpha, taken=()):
    cluster = pkg.Cluster.uniform(pods, nodes_per_pod)
    cluster.allocate(list(taken))
    comm = pkg.build_comm_matrix(pkg.JobSpec(n_gpus=n_gpus, tp=tp, pp=pp, model=model(pkg)))
    return pkg.get_scheduler("mip").schedule(
        pkg.ScheduleRequest(comm=comm, cluster=cluster, alpha=alpha)).placement


# (pods, nodes per pod, n_gpus, tp, pp, alpha, taken nodes, mesh shape): the
# reference test's case first, then a fragmented cluster whose free nodes
# are out of id order
CASES = [
    (4, 2, 64, 8, 2, 0.0, (), (8, 8)),
    (4, 4, 64, 4, 2, 0.3, (0, 5, 6, 9, 14), (8, 8)),
]


def reference_spreads(case) -> dict:
    pods, per_pod, n_gpus, tp, pp, alpha, taken, shape = case
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={pods * per_pod * 8}"
        import json
        import jax
        from repro.core import (Cluster, JobSpec, ModelSpec, ScheduleRequest,
                                build_comm_matrix, get_scheduler)
        from repro.launch.mesh import make_arnold_mesh, mesh_group_spread

        cluster = Cluster.uniform({pods}, {per_pod})
        cluster.allocate({list(taken)})
        model = ModelSpec(name="m", hidden=1024, layers=8, vocab=5000,
                          seq_len=128, global_batch=64, d_ff=4096)
        comm = build_comm_matrix(JobSpec(n_gpus={n_gpus}, tp={tp}, pp={pp}, model=model))
        res = get_scheduler("mip").schedule(
            ScheduleRequest(comm=comm, cluster=cluster, alpha={alpha}))
        mesh = make_arnold_mesh(res.placement, tp={tp}, shape={shape},
                                axes=("data", "model"))
        naive = jax.make_mesh({shape}, ("data", "model"))
        per = {per_pod * 8}
        out = {{f"{{name}}_{{axis}}": mesh_group_spread(m, axis, per)
               for name, m in (("arnold", mesh), ("naive", naive))
               for axis in ("data", "model")}}
        out["ids"] = [[d.id for d in row] for row in mesh.devices]
        print(json.dumps(out))
    """)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", CASES, ids=["reference-case", "fragmented"])
def test_group_spreads_equal_the_reference_mesh(case, fake_world):
    pods, per_pod, n_gpus, tp, pp, alpha, taken, shape = case
    want = reference_spreads(case)
    fake_world(pods * per_pod * 8)
    placement = mip_placement(P, pods, per_pod, n_gpus, tp, pp, alpha, taken)
    mesh = port_mesh.make_arnold_mesh(placement, tp=tp, shape=shape, axes=("data", "model"),
                                      device_type="cpu")
    naive = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    per = per_pod * 8
    got = {f"{name}_{axis}": port_mesh.mesh_group_spread(m, axis, per)
           for name, m in (("arnold", mesh), ("naive", naive)) for axis in ("data", "model")}
    assert mesh.mesh.tolist() == want.pop("ids")     # rank r is device r
    assert got == want
    assert got["arnold_model"] == 1                  # TP stays inside a node
    if not taken:                                    # the naive mesh is a valid job there
        assert got["arnold_data"] <= got["naive_data"]
    assert np.array_equal(port_mesh.mesh_device_minipods(mesh, per), mesh.mesh.numpy() // per)


def test_rank_grid_is_the_permutation(fake_world):
    fake_world(128)
    placement = mip_placement(P, 4, 2, 64, 8, 2, 0.0)
    perm = P.device_permutation(placement, 8)
    grid = port_mesh.arnold_rank_grid(placement, 8, (2, 4, 8), list(range(64)))
    assert grid.tolist() == np.asarray(perm).reshape(2, 4, 8).tolist()
    ranks = list(range(64, 128))                     # rank of GPU g is ranks[g]
    mesh = port_mesh.make_arnold_mesh(placement, 8, (2, 4, 8), ("pipe", "data", "model"),
                                      ranks=ranks, device_type="cpu")
    assert mesh.mesh.tolist() == (np.asarray(perm) + 64).reshape(2, 4, 8).tolist()
    assert mesh.mesh_dim_names == ("pipe", "data", "model")
    axes = ("pipe", "data", "model")
    assert port_mesh.grid_group_spread(grid, axes, "model", 8) == 1   # one node per TP group
    dp_spread, pp_spread = P.max_spreads(placement)      # 0 for a group inside one pod
    assert port_mesh.grid_group_spread(grid, axes, "data", 16) == max(dp_spread, 1)
    assert port_mesh.grid_group_spread(grid, axes, "pipe", 16) == max(pp_spread, 1)


def test_raises_when_the_world_is_too_small(fake_world):
    fake_world(32)
    placement = mip_placement(P, 4, 2, 64, 8, 2, 0.0)
    with pytest.raises(ValueError, match="needs 64 devices, have 32"):
        port_mesh.make_arnold_mesh(placement, 8, (8, 8), ("data", "model"), device_type="cpu")


@pytest.mark.parametrize("multi_pod,shape,axes", [
    (False, (16, 16), ("data", "model")), (True, (2, 16, 16), ("pod", "data", "model"))])
def test_production_mesh(multi_pod, shape, axes, fake_world):
    fake_world(256 * (2 if multi_pod else 1))
    mesh = port_mesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert tuple(mesh.mesh.shape) == shape and mesh.mesh_dim_names == axes
    assert mesh.mesh.flatten().tolist() == list(range(int(np.prod(shape))))
