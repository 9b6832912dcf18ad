"""The port's parallelism layer on a 4-rank gloo world against the
reference's meshed functions on 4 fake host devices (``AxisType.Auto``
meshes), from the same converted weights and inputs.

One module fixture runs everything once: the reference's oracles
(``tests/jax_parallel_oracle.py``) beside the port's world
(``tests/torch_parallel_world.py``: every case on a (2, 2) ``data x model``
DeviceMesh, started once the oracle has written the inputs), then the meshed
launcher, ``--device cpu --devices 4 --mesh-shape 2x2 --arnold --scheduler
mip``, twice (the second run restarts from the first's checkpoint).  Each
rank and the oracle compute on one thread, so the module keeps at most five
of the machine's cores busy.

Tolerances: the meshed train step's losses within 1e-4 of the unmeshed
step's and of the reference's meshed step's (the reference's own rule,
``tests/test_distribution.py``), fp32, 3 steps; the seq-sharded decode's
logits within 1e-4 of the unsharded decode's and of the reference's; the
pipeline's forward within 1e-5 and its gradient within 1e-4 of the
reference's (``jax.grad`` of the pipelined loss); ``compressed_psum_mean``
within 1e-6 of the reference's, and the reference's bounds against the exact
mean (fp16 1e-2, int8 5e-2).

The trainer's meshed state (reduced glm4-9b, the launcher's fp32 masters and
bf16 compute): made in its layout, it is ``model.init`` of the same seed bit
for bit once gathered, and 3 steps from it give the losses, within 1e-6, of
the same meshed step fed the whole-tree init; a save leaves a host copy on
rank 0 alone, and the restored state is the saved one bit for bit.
"""

import os
import pathlib
import pickle
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from repro_torch.parallel.pipeline import pp_boundary_bytes
from repro_torch.parallel.sharding import param_spec

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
TRAIN_ARCHS = ("minicpm-2b", "qwen3-moe-235b-a22b", "zamba2-2.7b", "glm4-9b", "dbrx-132b")
DECODE_ARCHS = ("zamba2-2.7b", "xlstm-350m", "whisper-tiny", "dbrx-132b")
LAUNCH = ["-m", "repro_torch.launch.train", "--device", "cpu", "--devices", "4",
          "--mesh-shape", "2x2", "--arnold", "--scheduler", "mip", "--steps", "4",
          "--ckpt-every", "2", "--log-every", "1"]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(args, out=subprocess.PIPE) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=_env(), stdout=out,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc: subprocess.Popen, timeout: float = 600) -> str:
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-6000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    ckpt = tmp / "ckpt"
    oracle = _start([str(TESTS / "jax_parallel_oracle.py"), str(tmp)])
    deadline = time.time() + 300
    while not (tmp / "inputs.npz").exists():
        assert oracle.poll() is None, _finish(oracle)
        assert time.time() < deadline, "the oracle wrote no inputs"
        time.sleep(0.2)
    world = _start([str(TESTS / "torch_parallel_world.py"), str(tmp / "inputs.npz"),
                    str(tmp / "world.pkl")])
    _finish(world)
    _finish(oracle)
    first = _finish(_start([*LAUNCH, "--ckpt-dir", str(ckpt)]))
    # the second run restarts from the first's step-2 checkpoint
    shutil.rmtree(ckpt / "step_4")
    second = _finish(_start([*LAUNCH, "--ckpt-dir", str(ckpt)]))
    with open(tmp / "world.pkl", "rb") as f:
        port = pickle.load(f)
    ref = dict(np.load(tmp / "oracle.npz"))
    return {"port": port, "ref": ref, "launch": (first, second)}


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_meshed_train_step_matches_unmeshed_and_reference(runs, arch):
    got = runs["port"][f"train|{arch}"]
    want = runs["ref"][f"train|{arch}"]
    np.testing.assert_allclose(got["mesh"], got["plain"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["mesh"], want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_leaves_are_local_shards(runs, arch):
    """Every parameter and moment is a DTensor whose local shard has the
    shape its ``param_spec``/``opt_spec`` implies on the (2, 2) mesh: a step
    that replicated everything would fail here."""
    got = runs["port"][f"train|{arch}"]
    assert got["wrong_layouts"] == []
    assert got["sharded_leaves"] > 20
    (d, cols), local = got["first_leaf"]
    assert param_spec("layers/0/attn/wq", (d, cols), {"data": 2, "model": 2}) == ("data", "model")
    assert local == (d // 2, cols // 2)   # e.g. wq: (d/2, H hd/2)


def test_sharded_init_is_model_init_bit_for_bit(runs):
    """Every parameter made in its layout, gathered, equals ``model.init``'s
    leaf; every moment is fp32 zeros in its ``opt_shardings`` layout."""
    got = runs["port"]["trainer"]
    assert got["init_not_bitwise"] == []
    assert got["init_wrong_layouts"] == []
    assert got["moments_wrong"] == []


def test_sharded_init_trains_as_the_whole_tree_init(runs):
    got = runs["port"]["trainer"]
    assert len(got["sharded_init"]) == 3
    np.testing.assert_allclose(got["sharded_init"], got["whole_init"], rtol=0, atol=1e-6)


def test_a_meshed_save_keeps_one_host_copy(runs):
    """Every rank takes part in each leaf's gather, rank 0 alone keeps a host
    copy; the checkpoint comes back laid out as the step holds it, bit for bit."""
    got = runs["port"]["trainer"]
    assert got["host_copies_by_rank"] == [got["leaves"], 0, 0, 0]
    assert got["host_bytes_by_rank"][0] > 0 and got["host_bytes_by_rank"][1:] == [0, 0, 0]
    assert got["restored_step"] == (3, 3)
    assert got["restore_not_bitwise"] == []
    assert got["restore_wrong_layouts"] == []


def test_seq_sharded_decode(runs):
    got = runs["port"]["decode"]
    assert got["seq_sharded"]
    assert got["cache_spec"] == (None, "data", "model", None, None)   # (layers, b, L, K, hd)
    assert got["cache_local"] == (4, 2, 16, 3, 16)
    np.testing.assert_allclose(got["mesh"], got["plain"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["mesh"], runs["ref"]["decode"], rtol=0, atol=1e-4)


def test_head_sharded_decode(runs):
    """2 KV heads divide ``model``: the cache is sharded on its heads and the
    decode attends head by head on each rank's shard."""
    got = runs["port"]["decode_heads"]
    assert not got["seq_sharded"]
    assert got["cache_spec"] == (None, "data", None, "model", None)
    assert got["cache_local"] == (4, 2, 32, 1, 16)
    np.testing.assert_allclose(got["mesh"], got["plain"], rtol=0, atol=1e-4)


def test_pipeline_matches_reference(runs):
    got = runs["port"]["pipeline"]
    np.testing.assert_allclose(got["y"], runs["ref"]["pp_y"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["grad"], runs["ref"]["pp_grad"], rtol=0, atol=1e-4)
    # the boundary between stages 0 and 1: activations forward, gradients back
    crossed = got["sent"][0].get(1, 0) + got["sent"][1].get(0, 0)
    assert crossed == pp_boundary_bytes(2, 1, 16, 8, bytes_per_el=4)
    assert 3 not in got["sent"][0] and 0 not in got["sent"][3]   # no wrap-around traffic


@pytest.mark.parametrize("scheme,bound", [("fp16", 1e-2), ("int8", 5e-2)])
def test_compressed_psum_mean(runs, scheme, bound):
    got = runs["port"]["collectives"][scheme]
    np.testing.assert_allclose(got, runs["ref"][f"cc|{scheme}"], rtol=0, atol=1e-6)
    assert np.abs(got - runs["port"]["collectives"]["exact"]).max() < bound


def test_dp_grad_fn_matches_one_process(runs):
    loss, ref, err = runs["port"]["collectives"]["dp"]
    assert abs(loss - ref) < 1e-6
    assert err < 1e-3   # fp16 on the wire


def test_meshed_launcher_places_and_restarts(runs):
    first, second = runs["launch"]
    pods, spread = (int(v) for v in runs["ref"]["arnold"])
    line = f"pods={pods} spread(data axis)={spread}"
    for out in (first, second):
        assert re.search(r"^Arnold placement \[[\w-]+\]: " + re.escape(line) + "$", out, re.M), out
    steps = lambda out: {int(m[1]): m[2] for m in re.finditer(
        r"^step\s+(\d+)\s+(loss \S+\s+gnorm \S+)", out, re.M)}
    a, b = steps(first), steps(second)
    assert sorted(a) == [1, 2, 3, 4] and sorted(b) == [3, 4]
    assert b == {s: a[s] for s in (3, 4)}
    assert "done: first logged loss" in first


#: a recurrent, encoder-decoder or MoE cache leaf of each family and its layout
#: on the (2, 2) mesh: batch over ``data``, the state's or the KV's heads over
#: ``model`` (every reduced config has 4 of them)
FAMILY_CACHE_SPECS = {
    "zamba2-2.7b": ("S", (None, "data", "model", None, None)),
    "xlstm-350m": ("states/mlstm/C", (None, None, "data", "model", None, None)),
    "whisper-tiny": ("kv/k", (None, "data", None, "model", None)),
    "dbrx-132b": ("kv/k", (None, "data", None, "model", None)),
}


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_family_meshed_decode_matches_unmeshed_and_reference(runs, arch):
    """zamba2's ring cache and Mamba2 states, the xLSTM's states,
    Whisper's self- and cross-attention caches and dbrx-132b's KV cache (its
    experts over ``model``, ZeRO-3 over ``data``) through ``make_serve_step``:
    5 steps within 1e-4 of the unmeshed decode and of the reference's meshed
    decode, and every cache leaf still in its ``cache_shardings`` layout
    after the in-place writes."""
    got = runs["port"][f"decode|{arch}"]
    np.testing.assert_allclose(got["mesh"], got["plain"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["mesh"], runs["ref"][f"decode|{arch}"], rtol=0, atol=1e-4)
    assert got["wrong_layouts"] == []
    leaf, spec = FAMILY_CACHE_SPECS[arch]
    assert got["cache_specs"][leaf] == spec


@pytest.mark.parametrize("arch", ("minicpm-2b", "zamba2-2.7b", "dbrx-132b"))
def test_a_remat_step_gathers_each_layer_at_its_use(runs, arch):
    """ZeRO-3 gathers where the weights are used: in one meshed train step
    under remat each layer's leaves sharded over ``data`` are gathered twice,
    in the forward and in the recompute of the layer's checkpoint; the
    hybrid's shared block once, at the top of the forward; the embedding and
    the head once at each use (a tied table at the lookup and at the logits);
    a leaf not sharded over ``data`` never (``expected_gathers``).  No step
    gathers the whole tree.  Two such steps give the unmeshed remat step's
    losses within 1e-4 (the train step's rule above)."""
    from torch_parallel_world import expected_gathers

    got = runs["port"][f"gathers|{arch}"]
    assert any(p.startswith("layers/") for p in got["data_sharded"])
    assert got["gathers"] == expected_gathers(got)
    np.testing.assert_allclose(got["mesh"], got["plain"], rtol=0, atol=1e-4)


def test_moe_decode_on_a_1x4_mesh(runs):
    """dbrx-132b's decode with its experts and heads over a 4-way ``model``
    dimension (EP and TP 4, ``data`` of one: nothing gathered): 5 steps
    within 1e-4 of the unmeshed decode and of the reference's (2, 2) meshed
    decode, the KV cache's heads over ``model``."""
    got = runs["port"]["decode_1x4|dbrx-132b"]
    np.testing.assert_allclose(got["mesh"], got["plain"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["mesh"], runs["ref"]["decode|dbrx-132b"], rtol=0, atol=1e-4)
    assert got["wrong_layouts"] == []
    assert got["cache_specs"]["kv/k"] == (None, None, None, "model", None)
