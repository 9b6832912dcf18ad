"""The port's VLM family of ``DecoderLM`` (reduced phi-3-vision-4.2b: head
dim 16, 16 patches) against the reference's, on the CPU and the same numpy
inputs: the forward's logits at the token positions, the loss and every
gradient (``patch_proj`` included), the converter both ways, and the
launcher.  fp32: logits within 1e-5 and every gradient leaf within 1e-4 of
its largest element (sums in other orders over a few layers, as in
``tests/test_torch_train.py``); the loss within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build_model
from repro.train import loss_and_grads as jax_loss_and_grads
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_layout
from repro_torch.data import SyntheticDataset
from repro_torch.launch import train as launch_train
from repro_torch.models import ModelOptions, build_model
from repro_torch.train import loss_and_grads

ARCH = "phi-3-vision-4.2b"


def jax_tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def close(got, want, rel, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max() + 1e-12,
                               err_msg=what)


def model_pair(remat=False, seed=0):
    cfg_j, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jm = jax_build_model(cfg_j, JaxOptions(compute_dtype="float32", remat=remat))
    jp = jax_tree_np(jm.init(jax.random.PRNGKey(seed)))
    tm = build_model(cfg, ModelOptions("float32", "float32", remat=remat), device="cpu")
    return jm, jp, tm, from_jax_params(jp, cfg, torch.float32, "cpu")


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def vlm_batch(cfg, b=2, s=12, seed=5):
    """Tokens and labels from the data pipeline, patches from a seed (the
    launcher's ``extra_specs``)."""
    ds = SyntheticDataset(cfg.vocab, s, b, seed=seed,
                          extra_specs={"patches": ((b, cfg.n_patches, cfg.d_model), "float32")})
    return ds.batch(0)


def test_reduced_config_has_the_prefix():
    cfg = get_config(ARCH).reduced()
    assert (cfg.family, cfg.n_patches, cfg.resolved_head_dim, cfg.d_model) == ("vlm", 16, 16, 64)
    assert get_config(ARCH).resolved_head_dim == 96


def test_forward_logits_at_the_token_positions(pair):
    jm, jp, tm, tp = pair
    batch = vlm_batch(tm.cfg)
    want, aux_j = jm.forward(jp, {k: jnp.asarray(v) for k, v in batch.items() if k != "labels"})
    with torch.no_grad():
        got, aux = tm.forward(tp, {k: torch.from_numpy(v) for k, v in batch.items()
                                   if k != "labels"})
    assert got.shape == (2, 12, tm.cfg.padded_vocab)   # the 16 patch positions are not scored
    close(got, want, 1e-5, "logits")
    assert float(aux) == float(aux_j) == 0.0


def test_the_prefix_reaches_every_token_position(pair):
    """Positions and the causal mask run over patches and tokens: changing
    one patch moves every token's logits."""
    _, _, tm, tp = pair
    batch = {k: torch.from_numpy(v) for k, v in vlm_batch(tm.cfg).items() if k != "labels"}
    with torch.no_grad():
        a, _ = tm.forward(tp, batch)
        batch["patches"] = batch["patches"].clone()
        batch["patches"][:, -1] += 1.0
        b, _ = tm.forward(tp, batch)
    assert ((a - b).abs().amax(-1) > 1e-6).all()


@pytest.mark.parametrize("remat,microbatches", [(False, 1), (True, 1), (True, 2)])
def test_loss_and_every_gradient_match_the_reference(remat, microbatches):
    jm, jp, tm, params = model_pair(remat, seed=1)
    batch = vlm_batch(tm.cfg, b=4)
    batch["labels"][0, :3] = -1
    jloss, jmetrics, jgrads = jax_loss_and_grads(
        jm, jp, {k: jnp.asarray(v) for k, v in batch.items()}, microbatches)
    loss, metrics, grads = loss_and_grads(
        tm, params, {k: torch.from_numpy(v) for k, v in batch.items()}, microbatches)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(metrics["ce"]) == pytest.approx(float(jmetrics["ce"]), rel=1e-5)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"])   # the last microbatch's
    got, want = to_jax_layout(grads, tm.cfg), jax_tree_np(jgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        close(g, w, 1e-4, jax.tree_util.keystr(path))
    assert float(np.abs(got["patch_proj"]).max()) > 0


def test_converter_round_trip(pair):
    _, jp, tm, tp = pair
    np.testing.assert_array_equal(tp["patch_proj"].numpy(), jp["patch_proj"])
    assert from_jax_params(jp, tm.cfg, torch.bfloat16, "cpu")["patch_proj"].dtype == torch.bfloat16
    back = to_jax_layout(tp, tm.cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    own = tm.init(torch.Generator().manual_seed(0))
    assert own["patch_proj"].shape == tp["patch_proj"].shape == (tm.cfg.d_model, tm.cfg.d_model)


def test_serving_is_text_only(pair):
    """As the reference's: prefill and decode take no patches."""
    jm, jp, tm, tp = pair
    tokens = np.random.default_rng(0).integers(0, tm.cfg.vocab, (2, 1)).astype(np.int32)
    want, _ = jm.decode_step(jp, jm.init_cache(2, 4), jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = tm.decode_step(tp, tm.init_cache(2, 4), torch.from_numpy(tokens))
    close(got, want, 1e-5, "decode logits")


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    rc = launch_train.main(["--arch", ARCH, "--device", "cpu", "--steps", "16", "--log-every", "4",
                            "--ckpt-every", "8", "--ckpt-dir", str(tmp_path)])
    assert rc == 0   # the launcher's own rule: the last logged loss below the first
    assert "done: first logged loss" in capsys.readouterr().out
    assert Checkpointer(tmp_path).latest_step() == 16
