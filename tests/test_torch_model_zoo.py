"""The port's dry-run stand-ins (``repro_torch.models.model_zoo``) against the
reference's ``models/model_zoo.py``: for every architecture's reduced config
and every input shape, the ``meta`` tensors of ``input_specs`` have the
shapes and dtypes of the reference's ``ShapeDtypeStruct``s (the decode
cache's too: zamba2's Mamba2 states on one layer axis where the reference
stacks ``(units, per_unit)``; the cache ``index`` a Python int where the
reference holds an int32 scalar); and ``init`` of a model built on meta
builds ``init``'s tree -- paths, shapes, dtypes -- drawing nothing, equal
through the converter's names to ``jax.eval_shape`` of the reference's
``init``."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.models import ModelOptions as RefOptions
from repro.models import build_model as ref_build
from repro.models import input_specs as ref_input_specs
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.convert import to_jax_layout
from repro_torch.models import (
    ModelOptions,
    build_model,
    decode_input_specs,
    input_specs,
    prefill_input_specs,
    train_input_specs,
)
from repro_torch.parallel.sharding import map_with_path

CELLS = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)]


def port_leaves(tree) -> dict:
    out = {}
    map_with_path(lambda p, t: out.__setitem__(p, t), tree)
    return out


def ref_leaves(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    cfg, sh = get_config(arch).reduced(), SHAPES[shape]
    got = port_leaves(input_specs(cfg, sh))
    want = ref_leaves(ref_input_specs(ref_config(arch).reduced(), REF_SHAPES[shape]))
    assert got.keys() == want.keys()
    for path, spec in want.items():
        leaf = got[path]
        if path == "cache/index":
            assert leaf == 0 and spec.shape == () and dtype_name(spec.dtype) == "int32"
            continue
        shape_want = tuple(spec.shape)
        if cfg.family == "hybrid" and path in ("cache/S", "cache/conv"):
            # the port holds the Mamba2 layers on one axis: (units x per_unit, ...)
            shape_want = (shape_want[0] * shape_want[1],) + shape_want[2:]
        assert leaf.device.type == "meta", path
        assert (tuple(leaf.shape), dtype_name(leaf.dtype)) == (shape_want, dtype_name(spec.dtype)), path


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_spec_kinds(arch):
    cfg, opts = get_config(arch).reduced(), ModelOptions(compute_dtype="float32")
    train = train_input_specs(cfg, SHAPES["train_4k"], opts)
    assert set(prefill_input_specs(cfg, SHAPES["prefill_32k"], opts)) == set(train) - {"labels"}
    assert set(decode_input_specs(cfg, SHAPES["decode_32k"], opts)) == {"tokens", "cache"}
    extra = {"vlm": "patches", "audio": "frames"}.get(cfg.family)
    if extra:
        assert train[extra].dtype == torch.float32   # the compute dtype
    with pytest.raises(ValueError):
        input_specs(cfg, type(SHAPES["train_4k"])("x", 8, 1, "score"))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_init_on_meta_builds_init_s_tree_drawing_nothing(arch):
    cfg = get_config(arch).reduced()
    opts = ModelOptions(param_dtype="float32", compute_dtype="float32")
    abstract = port_leaves(build_model(cfg, opts, "meta").init())
    real_tree = build_model(cfg, opts, "cpu").init(torch.Generator().manual_seed(0))
    real = port_leaves(real_tree)
    assert abstract.keys() == real.keys()
    for path, t in real.items():
        a = abstract[path]
        assert a.device.type == "meta" and (a.shape, a.dtype) == (t.shape, t.dtype), path
    # through the converter's names, the reference's eval_shape of its init
    rcfg = ref_config(arch).reduced()
    rmodel = ref_build(rcfg, RefOptions(param_dtype="float32", compute_dtype="float32"))
    want = ref_leaves(jax.eval_shape(lambda: rmodel.init(jax.random.PRNGKey(0))))
    got = ref_leaves(to_jax_layout(real_tree, cfg))
    assert got.keys() == want.keys()
    for path, spec in want.items():
        assert np.shape(got[path]) == tuple(spec.shape), path


def test_meta_init_draws_nothing_and_takes_no_generator():
    cfg = get_config("zamba2-2.7b").reduced()
    model = build_model(cfg, ModelOptions(), "meta")
    generator = torch.Generator().manual_seed(0)
    before = generator.get_state()
    params = model.init(generator)
    assert torch.equal(before, generator.get_state())
    assert port_leaves(params).keys() == port_leaves(model.init()).keys()
