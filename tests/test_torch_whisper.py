"""``repro_torch.models.whisper`` against the reference's ``models/whisper.py``
from converted parameters, fp32 on the CPU, on the same numpy inputs: the
reduced whisper-tiny configuration (d_model 64, 2 encoder and 4 decoder
layers, 4 heads of 16, d_ff 128).  The reference's model code calls no Pallas
kernel; the port's goes through ``ops`` (the plain versions on the CPU).
Tolerance: atol 1e-4 on logits and module outputs (sums in another order);
each gradient leaf within 1e-4 of its norm, relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models import whisper as JW
from repro.train import loss_and_grads as jax_loss_and_grads
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_layout
from repro_torch.launch import train as launch_train
from repro_torch.models import ModelOptions, WhisperLM, build_model
from repro_torch.models import layers as L
from repro_torch.models import whisper as W
from repro_torch.train import loss_and_grads

ATOL = 1e-4
FP32 = ModelOptions(param_dtype="float32", compute_dtype="float32")
NAME = "whisper-tiny"


def make_pair(cfg_j, cfg_t, seed=0, remat=False):
    jm = jax_build_model(cfg_j, JaxOptions(compute_dtype="float32", remat=remat))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg_t, dataclasses.replace(FP32, remat=remat), device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg_t, torch.float32, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def pair():
    return make_pair(jax_get_config(NAME).reduced(), get_config(NAME).reduced())


@pytest.fixture(scope="module")
def pair_vocab500():
    """vocab 500 pads to 512: the logits mask is live; remat of each layer."""
    cj = dataclasses.replace(jax_get_config(NAME).reduced(), vocab=500)
    ct = dataclasses.replace(get_config(NAME).reduced(), vocab=500)
    return make_pair(cj, ct, seed=1, remat=True)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


def both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a)


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def batch(rng, cfg, b, s, frames):
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "frames": randn(rng, b, frames, cfg.d_model)}


def on_both(np_batch):
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


class TestConfig:
    def test_published_widths(self):
        c = get_config(NAME)
        assert (c.n_encoder_layers, c.n_layers, c.d_model, c.n_heads, c.n_kv_heads,
                c.resolved_head_dim, c.d_ff, c.vocab, c.padded_vocab) == (
                4, 4, 384, 6, 6, 64, 1536, 51865, 51968)
        assert W.N_FRAMES == JW.N_FRAMES == 1500
        assert c.param_count() == jax_get_config(NAME).param_count()

    def test_reduced_shape(self, pair):
        _, _, tm, tp = pair
        c = tm.cfg
        assert (c.n_encoder_layers, c.n_layers, c.d_model, c.resolved_head_dim) == (2, 4, 64, 16)
        assert (len(tp["enc_layers"]), len(tp["dec_layers"])) == (2, 4)

    def test_build_model_returns_whisper(self):
        model = build_model(get_config(NAME).reduced(), device="cpu")
        assert isinstance(model, WhisperLM) and model.device == torch.device("cpu")

    def test_cuda_is_the_default_and_is_not_silently_replaced(self):
        if torch.cuda.is_available():
            assert build_model(get_config(NAME).reduced()).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build_model(get_config(NAME).reduced())


class TestConvert:
    def test_round_trip_leaf_for_leaf(self, pair):
        _, jp, tm, tp = pair
        for stack in ("enc_layers", "dec_layers"):
            for i, tl in enumerate(tp[stack]):
                for group, leaves in tl.items():
                    for name, w in leaves.items():
                        close(w, jp[stack][group][name][i], atol=0)
                        assert w.dtype == torch.float32
        for name in ("enc_norm", "final_norm"):
            close(tp[name]["norm_scale"], jp[name]["norm_scale"], atol=0)
        close(tp["embed"]["tokens"], jp["embed"]["tokens"], atol=0)
        close(tp["frame_proj"], jp["frame_proj"], atol=0)
        assert "lm_head" not in tp   # tied to the embedding

    def test_structure_and_size_equal_init(self, pair):
        _, jp, tm, tp = pair
        own = tm.init(torch.Generator().manual_seed(0))

        def sig(tree):
            if isinstance(tree, dict):
                return {k: sig(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [sig(v) for v in tree]
            return (tuple(tree.shape), tree.dtype)

        assert sig(own) == sig(tp)
        assert sum(t.numel() for t in jax.tree.leaves(own)) == sum(
            np.asarray(a).size for a in jax.tree.leaves(jp))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_to_jax_layout_inverts_the_converter(self, pair, dtype):
        _, jp, tm, _ = pair
        want = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
        tp = from_jax_params(want, tm.cfg, dtype, "cpu")
        assert tp["dec_layers"][0]["xattn_norm"]["norm_scale"].dtype == torch.float32
        got = to_jax_layout(tp, tm.cfg)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
            name = jax.tree_util.keystr(path)
            assert g.shape == w.shape and g.dtype == np.float32, name
            exact = dtype == torch.float32 or name.endswith("['norm_scale']")
            expect = w if exact else torch.from_numpy(w).to(dtype).float().numpy()
            np.testing.assert_array_equal(g, expect, err_msg=name)

    def test_layer_count_mismatch_raises(self, pair):
        _, jp, tm, _ = pair
        with pytest.raises(ValueError, match="encoder"):
            from_jax_params(jax.tree.map(np.asarray, jp),
                            dataclasses.replace(tm.cfg, n_encoder_layers=3), device="cpu")


class TestModules:
    @pytest.mark.parametrize("s,d,offset", [(12, 64, 0), (1, 64, 7), (448, 384, 0),
                                            (1, 384, 447), (1500, 384, 0)])
    def test_sinusoid_pos(self, s, d, offset):
        got = W.sinusoid_pos(s, d, offset=offset)
        assert got.shape == (s, d) and got.dtype == torch.float32
        close(got, JW.sinusoid_pos(s, d, offset=offset))

    def test_gelu_mlp_is_the_tanh_form(self):
        rng = np.random.default_rng(0)
        p = {"mlp": {"w_in": randn(rng, 16, 32, scale=0.5), "w_out": randn(rng, 32, 16, scale=0.5)}}
        xj, xt = both(randn(rng, 2, 5, 16, scale=2.0))
        want = JW.gelu_mlp_fwd(jax.tree.map(jnp.asarray, p), xj)
        pt = jax.tree.map(torch.from_numpy, p)
        got = W.gelu_mlp_fwd(pt, xt)
        close(got, want)
        erf = torch.nn.functional.gelu(xt @ pt["mlp"]["w_in"]) @ pt["mlp"]["w_out"]
        assert (erf - got).abs().max() > 10 * ATOL   # the exact form is another function

    @pytest.mark.parametrize("frames", [24, 1500])
    def test_encode(self, pair, frames):
        jm, jp, tm, tp = pair
        fj, ft = both(randn(np.random.default_rng(frames), 2, frames, tm.cfg.d_model))
        with torch.no_grad():
            close(tm.encode(tp, ft), jm.encode(jp, fj))

    @pytest.mark.parametrize("use_rope", [True, False])
    def test_attention_decode_with_and_without_rope(self, use_rope):
        """``use_rope=False`` skips RoPE on q and on the new k, as the
        reference's; three steps into a dense cache."""
        rng = np.random.default_rng(3)
        d, hd, H, K, Lc = 32, 16, 4, 2, 8
        p = {"wq": randn(rng, d, H * hd, scale=0.2), "wk": randn(rng, d, K * hd, scale=0.2),
             "wv": randn(rng, d, K * hd, scale=0.2), "wo": randn(rng, H * hd, d, scale=0.2)}
        pj, pt = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.from_numpy, p)
        kw = dict(n_heads=H, n_kv_heads=K, head_dim=hd, use_rope=use_rope)
        cj = JL.init_kv_cache(2, Lc, K, hd, dtype=jnp.float32)
        ct = L.init_kv_cache(2, Lc, K, hd, dtype=torch.float32)
        for index in range(3):
            xj, xt = both(randn(rng, 2, 1, d))
            hj, cj = JL.attention_decode(pj, xj, cj, index, **kw)
            with torch.no_grad():
                ht, ct = L.attention_decode(pt, xt, ct, index, **kw)
            close(ht, hj)
            close(ct["k"], cj["k"])
            close(ct["v"], cj["v"])


class TestWhisperLM:
    @pytest.mark.parametrize("which,s,frames", [("pair", 12, 24), ("pair_vocab500", 12, 24),
                                                ("pair", 20, 1500)])
    def test_forward_logits(self, which, s, frames, request):
        jm, jp, tm, tp = request.getfixturevalue(which)
        bj, bt = on_both(batch(np.random.default_rng(s + frames), tm.cfg, 2, s, frames))
        want, _ = jax.jit(jm.forward)(jp, bj)
        with torch.no_grad():
            got, aux = tm.forward(tp, bt)
        assert got.shape == (2, s, tm.cfg.padded_vocab) and float(aux) == 0.0
        close(got, want)
        if tm.cfg.padded_vocab != tm.cfg.vocab:
            assert (got[..., tm.cfg.vocab:] == -1e30).all()

    @pytest.mark.parametrize("which", ["pair", "pair_vocab500"])
    def test_loss_and_grads_match_jax_grad(self, which, request):
        """The loss within 1e-5 and each leaf's gradient within 1e-4 of its
        norm, relative: the encoder's gradient comes through the
        cross-attention's K/V alone, the tied embedding's from both uses."""
        jm, jp, tm, tp = request.getfixturevalue(which)
        rng = np.random.default_rng(5)
        nb = batch(rng, tm.cfg, 2, 12, 24)
        nb["labels"] = rng.integers(0, tm.cfg.vocab, (2, 12)).astype(np.int32)
        nb["labels"][1, :4] = -1
        bj, bt = on_both(nb)
        jloss, _, jgrads = jax_loss_and_grads(jm, jp, bj)
        params = jax.tree.map(lambda t: t.detach().clone(), tp)
        loss, metrics, grads = loss_and_grads(tm, params, bt)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        assert float(metrics["tokens"]) == 20.0
        got = to_jax_layout(grads, tm.cfg)
        want = jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), jax.tree_util.keystr(path)

    def test_prefill_cross_replaces_the_cross_cache(self, pair):
        """``init_cache`` sizes the cross K/V for 1500 frames; a 24-frame
        prefill puts 24-frame tensors in their place (the cache it was given
        is left as it was), as the reference's."""
        jm, jp, tm, tp = pair
        cache = tm.init_cache(2, 8)
        assert cache["cross_k"].shape == (tm.cfg.n_layers, 2, 1500, tm.cfg.n_kv_heads, 16)
        fj, ft = both(randn(np.random.default_rng(8), 2, 24, tm.cfg.d_model))
        with torch.no_grad():
            filled = tm.prefill_cross(tp, cache, ft)
        want = jm.prefill_cross(jp, jm.init_cache(2, 8), fj)
        for name in ("cross_k", "cross_v"):
            assert filled[name].shape == (tm.cfg.n_layers, 2, 24, tm.cfg.n_kv_heads, 16)
            close(filled[name], want[name])
            assert not cache[name].any()
        assert filled["kv"] is cache["kv"] and filled["index"] == 0

    @pytest.mark.parametrize("frames", [24, 1500])
    def test_decode_steps_match_the_reference(self, pair_vocab500, frames):
        """prefill_cross, then six decode steps: logits and the self-attention
        cache equal the reference's step by step."""
        jm, jp, tm, tp = pair_vocab500
        rng = np.random.default_rng(frames)
        nb = batch(rng, tm.cfg, 3, 6, frames)
        cache_j = jax.jit(jm.prefill_cross)(jp, jm.init_cache(3, 6), jnp.asarray(nb["frames"]))
        with torch.no_grad():
            cache_t = tm.prefill_cross(tp, tm.init_cache(3, 6), torch.from_numpy(nb["frames"]))
        step = jax.jit(jm.decode_step)
        for t in range(6):
            tok = nb["tokens"][:, t: t + 1]
            want, cache_j = step(jp, cache_j, jnp.asarray(tok))
            with torch.no_grad():
                got, cache_t = tm.decode_step(tp, cache_t, torch.from_numpy(tok))
            close(got, want)
        assert cache_t["index"] == int(cache_j["index"]) == 6
        close(cache_t["kv"]["k"], cache_j["kv"]["k"])
        close(cache_t["kv"]["v"], cache_j["kv"]["v"])

    def test_forward_equals_teacher_forced_decode(self, pair):
        """Within the port: prefill_cross and teacher-forced decode reproduce
        the forward's logits (the flash path against the cached-K/V path)."""
        _, _, tm, tp = pair
        nb = batch(np.random.default_rng(9), tm.cfg, 2, 16, 24)
        bt = {k: torch.from_numpy(v) for k, v in nb.items()}
        with torch.no_grad():
            full, _ = tm.forward(tp, bt)
            cache = tm.prefill_cross(tp, tm.init_cache(2, 16), bt["frames"])
            steps = []
            for t in range(16):
                logits, cache = tm.decode_step(tp, cache, bt["tokens"][:, t: t + 1])
                steps.append(logits)
        close(torch.cat(steps, dim=1), full.numpy())


def test_launcher_gives_the_audio_family_frames(tmp_path, capsys, monkeypatch):
    """The launcher's batches carry frames (global batch, 24, d_model), as the
    reference's, and the reduced whisper trains with its loss falling."""
    seen = []
    real = WhisperLM.loss
    monkeypatch.setattr(WhisperLM, "loss", lambda self, p, b: seen.append(
        tuple(b["frames"].shape)) or real(self, p, b))
    rc = launch_train.main(["--arch", NAME, "--device", "cpu", "--steps", "12",
                            "--log-every", "4", "--ckpt-every", "6", "--ckpt-dir", str(tmp_path)])
    assert rc == 0
    assert "done: first logged loss" in capsys.readouterr().out
    assert Checkpointer(tmp_path).latest_step() == 12
    assert seen and set(seen) == {(8, 24, 64)}
