"""The port's sharding rules against the reference's, in one process, on the
production mesh shapes given as ``{name: size}``: every leaf of every
config's full-width parameter tree (shapes only: fake tensors for the port,
``jax.eval_shape`` for the reference), every leaf of every model family's
cache, the spec <-> placements round trip, and the compressed collectives'
quantizers (bit for bit on the same numpy inputs) and error feedback.

The port holds layers in lists, the reference stacks them: the port's
``layers/3/attn/wq`` is the reference's ``layers/attn/wq`` (zamba2's Mamba2
layers: the reference's ``units/...``, stacked ``(units, per_unit)``), with
the stacked leading dimensions dropped from the reference's spec.  Where the
reference's ZeRO-3 choice of "the largest replicated dimension" lands on a
stacked dimension the two cannot agree; ``STACKED_ZERO3`` lists each such
leaf (ROADMAP.md, queue C).
"""

import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_get_config
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build_model
from repro.parallel import collectives as jcol
from repro.parallel import sharding as jshd
from repro.train.train_step import cache_shardings as jax_cache_shardings
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import ModelOptions, build_model
from repro_torch.parallel import collectives as tcol
from repro_torch.parallel import sharding as shd
from repro_torch.train.train_step import cache_shardings

MESHES = {
    "2x4": {"data": 2, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}
CACHE_BATCH, CACHE_LEN = 32, 4096

#: (config, mesh, "param" or "opt", reference path) -> the reference's spec,
#: whose ZeRO-3 dimension is a stacked one.  xlstm-350m's mLSTM forget-gate
#: bias is (6 units, 3 per unit, 4 heads) in the reference: the largest
#: dimension, the units, goes over ``data``; the port's (4,) leaf shards its
#: heads instead (ROADMAP.md, queue C).
STACKED_ZERO3 = {
    ("xlstm-350m", "2x4", kind, "units/mlstm/ssm/f_bias"): ("data", None, None)
    for kind in ("param", "opt")
}


def ref_mesh(sizes: dict):
    """What the reference's rule functions read of a mesh: its axis names and
    sizes."""
    return SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


def ref_path(arch: str, path: str) -> str:
    parts = [p for p in path.split("/") if not p.isdigit()]
    if get_config(arch).family == "hybrid" and parts[0] == "layers":
        parts[0] = "units"
    return "/".join(parts)


def norm_spec(spec) -> tuple:
    """A spec (port tuple or reference PartitionSpec) as a tuple of None,
    names and tuples of names."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in spec)


def port_shapes(tree_fn) -> dict:
    with FakeTensorMode():
        tree = tree_fn()
    out = {}
    shd.map_with_path(lambda p, t: out.__setitem__(p, tuple(t.shape)) if hasattr(t, "shape") else None,
                      tree)
    return out


def ref_shapes(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def trees():
    """{arch: (port {path: shape}, reference {path: shape})} at full width."""
    out = {}
    for arch in ARCHS:
        model = build_model(get_config(arch), ModelOptions(param_dtype="float32"), device="cpu")
        jmodel = jax_build_model(jax_get_config(arch), JaxOptions())
        out[arch] = (port_shapes(lambda: model.init(torch.Generator())),
                     ref_shapes(jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_opt_specs_equal_the_reference(trees, arch, mesh):
    sizes = MESHES[mesh]
    port, ref = trees[arch]
    assert {ref_path(arch, p) for p in port} == set(ref)
    diffs = {}
    for path, shape in port.items():
        rpath = ref_path(arch, path)
        rshape = ref[rpath]
        lead = len(rshape) - len(shape)
        assert rshape[lead:] == shape, (path, rshape)
        for kind, mine, theirs in (("param", shd.param_spec, jshd.param_spec),
                                   ("opt", shd.opt_spec, jshd.opt_spec)):
            want = norm_spec(theirs(rpath, rshape, ref_mesh(sizes)))
            want = want + (None,) * (len(rshape) - len(want))
            got = mine(path, shape, sizes)
            if want[lead:] != got or any(e is not None for e in want[:lead]):
                diffs[(arch, mesh, kind, rpath)] = want
    assert diffs == {k: v for k, v in STACKED_ZERO3.items() if k[:2] == (arch, mesh)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_equal_the_reference(arch, mesh):
    """``cache_shardings`` from each family's ``cache_axes`` against the
    reference's, leaf by leaf (the port's zamba2 states stack the Mamba2
    layers on one axis where the reference's take two)."""
    sizes = MESHES[mesh]
    model = build_model(get_config(arch), ModelOptions(), device="cpu")
    jmodel = jax_build_model(jax_get_config(arch), JaxOptions())
    with FakeTensorMode():
        cache = model.init_cache(CACHE_BATCH, CACHE_LEN)
    got = {}
    shd.map_with_path(lambda p, s: got.__setitem__(p, s), cache_shardings(cache, sizes, model=model))
    jcache = jax.eval_shape(lambda: jmodel.init_cache(CACHE_BATCH, CACHE_LEN))
    amesh = jax.sharding.AbstractMesh(tuple(sizes.values()), tuple(sizes))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): s
            for path, s in jax.tree_util.tree_flatten_with_path(
                jax_cache_shardings(jcache, amesh, model=jmodel))[0]}
    shapes = ref_shapes(jcache)
    assert set(want) == set(got)
    for path, sharding in got.items():
        wspec = norm_spec(want[path].spec)
        wspec = wspec + (None,) * (len(shapes[path]) - len(wspec))
        if sharding is None:                       # the index: a Python int in the port
            assert shapes[path] == () and wspec == ()
            continue
        lead = len(shapes[path]) - len(sharding.spec)
        assert all(e is None for e in wspec[:lead])
        assert sharding.spec == wspec[lead:], (path, sharding.spec, wspec)


def test_the_reference_families_have_cache_axes():
    for arch in ("glm4-9b", "zamba2-2.7b", "xlstm-350m", "whisper-tiny", "qwen3-moe-235b-a22b"):
        model = build_model(get_config(arch).reduced(), ModelOptions(), device="cpu")
        jmodel = jax_build_model(jax_get_config(arch).reduced(), JaxOptions())
        axes = model.cache_axes()
        assert set(axes) == set(jmodel.cache_axes())


@pytest.mark.parametrize("spec,mesh", [
    (("data", "model"), "2x4"),
    ((None, "model", None), "16x16"),
    ((("pod", "data"), None, "model"), "2x16x16"),
    (("model", None, ("pod", "data")), "2x16x16"),
    ((None, None), "2x4"),
])
def test_placements_round_trip(spec, mesh):
    from torch.distributed.tensor import Replicate, Shard

    sizes = MESHES[mesh]
    placements = shd.to_placements(spec, sizes)
    assert len(placements) == len(sizes)
    for name, p in zip(sizes, placements):
        dims = [d for d, e in enumerate(spec) if name in shd._entry_names(e)]
        assert p == (Shard(dims[0]) if dims else Replicate())
    assert shd.from_placements(placements, sizes, len(spec)) == spec


def test_placements_refuse_a_spec_out_of_mesh_order():
    with pytest.raises(ValueError, match="mesh order"):
        shd.to_placements((("data", "pod"),), MESHES["2x16x16"])


def test_resolve_spec_degrades_indivisible_dims():
    rules = shd.default_rules(("data", "model"))
    mesh = MESHES["2x4"]
    assert shd.resolve_spec(("batch", None, "kv_heads", None), (8, 128, 2, 64), mesh, rules) \
        == ("data", None, None, None)
    assert shd.resolve_spec(("batch", None, "kv_heads", None), (8, 128, 4, 64), mesh, rules) \
        == ("data", None, "model", None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantizers_are_bit_identical(seed):
    x = np.random.default_rng(seed).standard_normal((4, 257)).astype(np.float32) * 3.0
    q16 = tcol.quantize_fp16(torch.from_numpy(x)).numpy()
    assert np.array_equal(q16.view(np.uint16), np.asarray(jcol.quantize_fp16(x)).view(np.uint16))
    q8, s8 = tcol.quantize_int8(torch.from_numpy(x))
    jq8, js8 = jcol.quantize_int8(jnp.asarray(x))
    assert np.array_equal(q8.numpy(), np.asarray(jq8)) and float(s8) == float(js8)
    assert np.array_equal(tcol.dequantize_int8(q8, s8).numpy(),
                          np.asarray(jcol.dequantize_int8(jq8, js8)))


@pytest.mark.parametrize("scheme", ["fp16", "int8"])
def test_compress_with_feedback_is_bit_identical(scheme):
    rng = np.random.default_rng(7)
    grads = [{"w": rng.standard_normal((3, 33)).astype(np.float32)} for _ in range(5)]
    res_t = tcol.init_error_feedback({"w": torch.zeros(3, 33)})
    res_j = jcol.init_error_feedback({"w": jnp.zeros((3, 33))})
    for g in grads:
        out_t, res_t = tcol.compress_with_feedback({"w": torch.from_numpy(g["w"])}, res_t, scheme)
        out_j, res_j = jcol.compress_with_feedback({"w": jnp.asarray(g["w"])}, res_j, scheme)
        assert np.array_equal(out_t["w"].numpy(), np.asarray(out_j["w"]))
        assert np.array_equal(res_t["w"].numpy(), np.asarray(res_j["w"]))


def test_error_feedback_unbiased():
    """The reference's drift test: error feedback keeps the long-run mean of
    int8-compressed gradients at the true value."""
    g = {"w": torch.full((64,), 0.100048828125)}   # not fp16-representable
    res = tcol.init_error_feedback(g)
    total = torch.zeros(64)
    n = 64
    for _ in range(n):
        cg, res = tcol.compress_with_feedback(g, res, "int8")
        total = total + cg["w"]
    assert float((total / n - g["w"]).abs().max()) < 1e-3


def test_lshard_is_a_no_op_without_a_mesh():
    x = torch.randn(2, 3, 4)
    assert shd.lshard(x, "batch", "seq", "embed") is x
    assert shd.pshard(x, "data", None, "model") is x
    assert re.match(r"\(\)", str(shd.data_axis_names()))


def test_the_active_mesh_reaches_autograd_s_device_thread():
    """A CUDA backward -- and with it each remat recompute, where the layers
    gather their ZeRO-3 weights and lay their activations out again -- runs
    on autograd's device thread, not on the thread that entered ``activate``:
    the mesh and rules are seen there too, and gone once the context ends."""
    import threading

    mesh, seen = {"data": 2, "model": 2}, []
    with shd.activate(mesh):
        probe = threading.Thread(target=lambda: seen.append(
            (shd.active_mesh(), shd._fsdp_dims(), shd.data_axis_names())))
        probe.start()
        probe.join()
    assert seen == [(mesh, [0], ("data",))]
    assert shd.active_mesh() is None and shd._fsdp_dims() == []


def test_one_mesh_is_active_at_a_time():
    """The active mesh is the process's: the same mesh may be entered again
    inside its own context, another mesh raises there, and both are free to
    enter once the context has ended."""
    first, other = {"data": 2, "model": 2}, {"data": 1, "model": 4}
    with shd.activate(first):
        with shd.activate(first):
            assert shd.active_mesh() is first
        with pytest.raises(RuntimeError, match="another mesh is active"):
            with shd.activate(other):
                pass
        assert shd.active_mesh() is first
    with shd.activate(other):
        assert shd.active_mesh() is other
    assert shd.active_mesh() is None
