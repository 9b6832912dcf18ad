"""``ModelOptions.remat_policy`` of the port's ``DecoderLM`` against the
reference's: ``"save_tp_outputs"`` (the reference's
``save_only_these_names("attn_out", "mlp_out")``) gives the reference's loss
and every gradient under the same policy on reduced minicpm-2b and
qwen3-moe (fp32; the loss within 1e-5, each gradient leaf within 1e-4 of its
largest element, the rule of ``tests/test_torch_train.py``) and the port's
own ``"full"`` bit for bit; it saves two tensors a layer and replays none of
them; on a (2, 2) fake world its recompute issues no collective; an unknown
policy raises."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_config
from repro.models import ModelOptions as RefOptions
from repro.models import build_model as ref_build
from repro.train import loss_and_grads as ref_loss_and_grads
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.convert import from_jax_params, to_jax_layout
from repro_torch.data import SyntheticDataset
from repro_torch.launch import dryrun
from repro_torch.launch.roofline import CollectiveBytes
from repro_torch.models import ModelOptions, build_model
from repro_torch.train import loss_and_grads

ARCHS = ("minicpm-2b", "qwen3-moe-235b-a22b")


def fp32(policy: str, remat: bool = True) -> ModelOptions:
    return ModelOptions("float32", "float32", remat=remat, remat_policy=policy)


def port_run(arch: str, jax_params, policy: str, batch: dict):
    cfg = get_config(arch).reduced()
    model = build_model(cfg, fp32(policy), "cpu")
    params = from_jax_params(jax.tree.map(np.asarray, jax_params), cfg, torch.float32, "cpu")
    loss, metrics, grads = loss_and_grads(model, params, {k: torch.from_numpy(v)
                                                          for k, v in batch.items()})
    return float(loss), to_jax_layout(grads, cfg)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    cfg = ref_config(arch).reduced()
    rmodel = ref_build(cfg, RefOptions(compute_dtype="float32", remat=True,
                                       remat_policy="save_tp_outputs"))
    params = rmodel.init(jax.random.PRNGKey(0))
    batch = SyntheticDataset(cfg.vocab, 16, 4, seed=3).batch(0)
    batch["labels"][0, :5] = -1
    rloss, _, rgrads = ref_loss_and_grads(rmodel, params,
                                          {k: jnp.asarray(v) for k, v in batch.items()}, 1)
    return arch, params, batch, float(rloss), jax.tree.map(lambda a: np.asarray(a, np.float32),
                                                           rgrads)


def test_save_tp_outputs_matches_the_reference_and_full(case):
    arch, params, batch, rloss, rgrads = case
    loss, grads = port_run(arch, params, "save_tp_outputs", batch)
    assert loss == pytest.approx(rloss, rel=1e-5)
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, want in jax.tree_util.tree_leaves_with_path(rgrads):
        np.testing.assert_allclose(got[path], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max() + 1e-12,
                                   err_msg=jax.tree_util.keystr(path))
    full_loss, full_grads = port_run(arch, params, "full", batch)
    assert loss == full_loss
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(full_grads)):
        np.testing.assert_array_equal(a, b)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        ModelOptions(remat_policy="save_everything")


class _Phases(TorchDispatchMode):
    """Ops seen, by (name, forward or backward); an op the checkpoint's
    recompute answers from what it saved never reaches this outer mode."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        phase = "backward" if torch._C._current_graph_task_id() != -1 else "forward"
        self.seen[(str(func), phase)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,saved", [("full", 0), ("save_tp_outputs", 2)])
def test_two_outputs_a_layer_are_saved_and_never_replayed(policy, saved):
    cfg = get_config("minicpm-2b").reduced()
    model = build_model(cfg, fp32(policy), "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticDataset(cfg.vocab, 16, 2).batch(0).items()}
    with _Phases() as mode:
        loss_and_grads(model, params, batch)
    op = "repro_torch.saved_output.default"
    assert mode.seen[(op, "forward")] == saved * cfg.n_layers
    assert mode.seen[(op, "backward")] == 0


class _BackwardCollectives(CollectiveBytes):
    """Collectives issued while autograd runs the backward (the recompute
    included)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if torch._C._current_graph_task_id() == -1:
            from torch.distributed.tensor import DTensor

            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


def _zero3_layer_leaves(cfg) -> int:
    """The layer leaves that ZeRO-3 shards over ``data`` on the (2, 2) mesh."""
    from repro_torch.parallel.sharding import map_with_path, param_spec

    found = []

    def leaf(path, t):
        spec = param_spec(path, t.shape, {"data": 2, "model": 2})
        names = [n for e in spec if e for n in (e if isinstance(e, tuple) else (e,))]
        if path.startswith("layers/") and "data" in names:
            found.append(path)

    map_with_path(leaf, build_model(cfg, fp32("full"), "meta").init())
    return len(found)


def test_recompute_issues_no_collective_on_a_mesh():
    """Reduced minicpm-2b, one meshed train step on a (2, 2) fake world on
    meta tensors: the backward of ``save_tp_outputs`` issues exactly the
    collectives of a step without remat and, under both policies, the
    recompute's gathers of each layer's ZeRO-3 leaves (each layer gathers its
    weights inside its checkpoint, as the reference's rematerialised scan
    body does): no tensor-parallel collective is replayed; ``full`` replays
    each layer's attention all-reduce too (its MLP's is past the last tensor
    the recompute needs); the FLOPs of both policies are equal."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = get_config("minicpm-2b").reduced()
    shape = ShapeSpec("t", 64, 4, "train")
    out = {}
    for name, opts in (("none", dryrun.options_for("minicpm-2b", "train_4k", {"remat": False})),
                       ("full", dryrun.options_for("minicpm-2b", "train_4k")),
                       ("save_tp", dryrun.options_for("minicpm-2b", "train_4k",
                                                      {"remat_policy": "save_tp_outputs"}))):
        with dryrun.fake_world(4):
            mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
            args, step, _ = dryrun._cell_step(cfg, shape, mesh, opts, 1)
            counts = dryrun.StepCounts()
            with counts:
                with _BackwardCollectives() as backward:
                    step(*args)
        out[name] = (backward.counts, counts.flops)
    regathers = _zero3_layer_leaves(cfg)
    assert regathers == 7 * cfg.n_layers
    assert out["save_tp"][0] == {**out["none"][0], "all-gather": regathers}
    assert out["full"][0]["all-reduce"] == out["none"][0]["all-reduce"] + cfg.n_layers
    assert out["full"][0]["all-gather"] == regathers
    assert out["save_tp"][1] == out["full"][1] > out["none"][1]
