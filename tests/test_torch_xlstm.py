"""``repro_torch.models.xlstm`` against the reference's ``models/xlstm.py`` from
converted parameters, fp32 on the CPU, on the same numpy inputs: the reduced
xlstm-350m configuration (d_model 64, 2 units of 1 mLSTM + 1 sLSTM block, 4
heads of 32).  Tolerance: atol 1e-4 on logits and module outputs (sums of a
few hundred fp32 terms taken in another order; the recurrences add no more
over 256 steps, since the stabilised gates keep every state bounded); each
gradient leaf within 1e-4 of its norm, relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build_model
from repro.models import xlstm as JX
from repro.train import loss_and_grads as jax_loss_and_grads
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_layout
from repro_torch.launch import train as launch_train
from repro_torch.models import XLSTMLM, ModelOptions, build_model
from repro_torch.models import xlstm as X
from repro_torch.train import loss_and_grads

ATOL = 1e-4
FP32 = ModelOptions(param_dtype="float32", compute_dtype="float32")
NAME = "xlstm-350m"


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
    """vocab 500 pads to 512: the logits mask is live; remat of each unit."""
    cj = dataclasses.replace(jax_get_config(NAME).reduced(), vocab=500)
    ct = dataclasses.replace(get_config(NAME).reduced(), vocab=500)
    return make_pair(cj, ct, seed=1, remat=True)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


def both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a)


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def block_params(jp, tp, u, kind, j=0):
    """Block ``j`` of unit ``u`` (``kind`` "mlstm" or "slstm") of both models."""
    if kind == "mlstm":
        return jax.tree.map(lambda a: a[u, j], jp["units"]["mlstm"]), tp["units"][u]["mlstm"][j]
    return jax.tree.map(lambda a: a[u], jp["units"]["slstm"]), tp["units"][u]["slstm"]


def with_bias(jl, tl, rng):
    """The block with a random ``f_bias`` on both sides, so that where it
    lands is visible (the init's is 3.0 everywhere)."""
    bias = randn(rng, *tl["ssm"]["f_bias"].shape)
    jl = {**jl, "ssm": {**jl["ssm"], "f_bias": jnp.asarray(bias)}}
    tl = {**tl, "ssm": {**tl["ssm"], "f_bias": torch.from_numpy(bias)}}
    return jl, tl


def tokens(rng, cfg, b, s):
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


class TestConfig:
    def test_published_widths(self):
        c = get_config(NAME)
        model = XLSTMLM(c, device="cpu")
        assert (c.n_layers, c.d_model, c.n_heads, c.slstm_every, c.ssm_expand, c.vocab,
                c.padded_vocab) == (24, 1024, 4, 4, 2, 50304, 50432)
        # the head width is d_in / n_heads, not cfg.head_dim (256), as the reference's
        assert (model.n_units, model.m_per_unit, model.d_in, model.dh) == (6, 3, 2048, 512)
        assert c.param_count() == jax_get_config(NAME).param_count()

    def test_reduced_shape(self, pair):
        _, _, tm, tp = pair
        assert (tm.cfg.d_model, tm.n_units, tm.m_per_unit, tm.dh) == (64, 2, 1, 32)
        assert len(tp["units"]) == 2 and len(tp["units"][0]["mlstm"]) == 1

    def test_build_model_returns_xlstm(self):
        model = build_model(get_config(NAME).reduced(), device="cpu")
        assert isinstance(model, XLSTMLM) and model.device == torch.device("cpu")

    def test_cuda_is_the_default_and_is_not_silently_replaced(self):
        if torch.cuda.is_available():
            assert build_model(get_config(NAME).reduced()).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build_model(get_config(NAME).reduced())


class TestConvert:
    def test_round_trip_leaf_for_leaf(self, pair):
        _, jp, tm, tp = pair
        for u in range(tm.n_units):
            for kind in ("mlstm", "slstm"):
                jl, tl = block_params(jp, tp, u, kind)
                for name, w in tl["ssm"].items():
                    close(w, jl["ssm"][name], atol=0)
                close(tl["norm"]["norm_scale"], jl["norm"]["norm_scale"], atol=0)
                assert tl["norm"]["norm_scale"].dtype == torch.float32
        close(tp["embed"]["tokens"], jp["embed"]["tokens"], atol=0)
        close(tp["lm_head"], jp["lm_head"], atol=0)
        close(tp["final_norm"]["norm_scale"], jp["final_norm"]["norm_scale"], atol=0)

    def test_structure_and_size_equal_init(self, pair):
        """Converted parameters have the structure, shapes and dtypes of the
        port's own ``init``, and as many numbers as the reference's."""
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
        """``to_jax_layout`` gives back the reference's tree, mLSTM blocks
        stacked (n_units, m_per_unit, ...) and sLSTM blocks (n_units, ...),
        leaf for leaf (bf16 weights: their bf16 values, norm scales exact)."""
        _, jp, tm, _ = pair
        want = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
        got = to_jax_layout(from_jax_params(want, tm.cfg, dtype, "cpu"), tm.cfg)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
            name = jax.tree_util.keystr(path)
            assert g.shape == w.shape and g.dtype == np.float32, name
            exact = dtype == torch.float32 or name.endswith("['norm_scale']")
            expect = w if exact else torch.from_numpy(w).to(dtype).float().numpy()
            np.testing.assert_array_equal(g, expect, err_msg=name)

    def test_an_xlstm_tree_is_not_read_as_a_hybrid(self, pair):
        """Both trees hold ``units`` (the hybrid's conversion is
        ``test_torch_zamba.py``'s); the xLSTM's is told apart by its keys."""
        _, jp, tm, tp = pair
        assert "shared" not in jp and "mlstm" in jp["units"]
        assert set(tp) == {"embed", "units", "final_norm", "lm_head"}
        assert set(tp["units"][0]) == {"mlstm", "slstm"}

    def test_unit_count_mismatch_raises(self, pair):
        _, jp, tm, _ = pair
        with pytest.raises(ValueError, match="sLSTM"):
            from_jax_params(jax.tree.map(np.asarray, jp),
                            dataclasses.replace(tm.cfg, n_layers=6, slstm_every=3), device="cpu")

    def test_default_device_is_the_card(self, pair, monkeypatch):
        _, jp, tm, _ = pair
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg)


class TestCells:
    def test_mlstm_step(self):
        """Four steps from a random state, the running max m included."""
        rng = np.random.default_rng(0)
        b, H, dh = 2, 3, 8
        sj = {"C": randn(rng, b, H, dh, dh), "n": randn(rng, b, H, dh), "m": randn(rng, b, H)}
        st = {k: torch.from_numpy(v) for k, v in sj.items()}
        sj = {k: jnp.asarray(v) for k, v in sj.items()}
        for _ in range(4):
            inp = [randn(rng, b, H, dh) for _ in range(3)] + [randn(rng, b, H, scale=2.0)
                                                              for _ in range(2)]
            sj, hj = JX._mlstm_step(sj, tuple(jnp.asarray(a) for a in inp))
            st, ht = X._mlstm_step(st, tuple(torch.from_numpy(a) for a in inp))
            close(ht, hj)
            for k in st:
                close(st[k], sj[k])

    def test_slstm_step(self, pair):
        _, jp, tm, tp = pair
        jl, tl = block_params(jp, tp, 1, "slstm")
        H, dh = tm.cfg.n_heads, tm.dh
        rng = np.random.default_rng(1)
        sj = JX.slstm_state(2, H, dh)
        st = X.slstm_state(2, H, dh)
        for _ in range(4):
            xg = randn(rng, 2, 4 * H * dh)
            sj = JX._slstm_step(jl["ssm"], sj, jnp.asarray(xg), H, dh)
            st = X._slstm_step(tl["ssm"], st, torch.from_numpy(xg), H, dh)
            for k in st:
                close(st[k], sj[k])

    def test_initial_states(self):
        for ours, theirs in ((X.mlstm_state(2, 4, 8), JX.mlstm_state(2, 4, 8)),
                             (X.slstm_state(2, 4, 8), JX.slstm_state(2, 4, 8))):
            assert ours.keys() == theirs.keys()
            for k in ours:
                assert ours[k].dtype == torch.float32
                close(ours[k], theirs[k], atol=0)

    @pytest.mark.parametrize("kind", ["mlstm", "slstm"])
    @pytest.mark.parametrize("s", [1, 12])
    def test_block_fwd_from_a_carried_state(self, pair, kind, s):
        """A block over s steps from the state a first call left, with a
        random f_bias: the output and the final state."""
        _, jp, tm, tp = pair
        rng = np.random.default_rng(s)
        jl, tl = with_bias(*block_params(jp, tp, 1, kind), rng)
        fwd_j, fwd_t = (JX.mlstm_fwd, X.mlstm_fwd) if kind == "mlstm" else (JX.slstm_fwd, X.slstm_fwd)
        init_j, init_t = ((JX.mlstm_state, X.mlstm_state) if kind == "mlstm"
                          else (JX.slstm_state, X.slstm_state))
        sj, st = init_j(2, tm.cfg.n_heads, tm.dh), init_t(2, tm.cfg.n_heads, tm.dh)
        eps = tm.cfg.norm_eps
        with torch.no_grad():
            for _ in range(2):
                xj, xt = both(randn(rng, 2, s, tm.cfg.d_model))
                yj, sj = fwd_j(jl, xj, sj, eps)
                yt, st = fwd_t(tl, xt, st, eps)
                close(yt, yj)
                for k in st:
                    close(st[k], sj[k])

    def test_slstm_bias_lands_on_head_1s_whole_block(self, pair):
        """The reference adds ``f_bias`` at [d_in, 2 d_in) of the flat gate
        axis; the step's per-head split reads that as head 1's i, f, z and o
        (H = 4, 4 dh = d_in), not as every head's f gate."""
        _, _, tm, tp = pair
        p = tp["units"][0]["slstm"]["ssm"]
        H, dh = tm.cfg.n_heads, tm.dh
        bias = X.slstm_bias(p, torch.float32).reshape(H, 4 * dh)
        assert (bias[1] == 3.0).all()
        assert (bias[[0, 2, 3]] == 0.0).all()

    def test_slstm_recurrent_init_reads_its_fan_in_on_dh(self):
        """The port's own ``init`` draws r_gates (H, dh, 4 dh) with fan-in dh
        (a truncated normal's std, 0.88 / sqrt(dh)); the reference reads it on
        n_heads, which leaves xlstm-350m's sLSTM chaotic (module note)."""
        model = XLSTMLM(get_config(NAME).reduced(), device="cpu")
        r = model.init(torch.Generator().manual_seed(0))["units"][0]["slstm"]["ssm"]["r_gates"]
        assert r.shape == (4, model.dh, 4 * model.dh)
        assert 0.8 < r.std().item() * model.dh ** 0.5 < 0.95

    def test_segmented_scan_checkpoints_only_under_autograd(self, pair, monkeypatch):
        """256 steps are two 128-step segments: under autograd each runs in a
        checkpoint, without it none does, and the outputs agree."""
        _, jp, tm, tp = pair
        jl, tl = block_params(jp, tp, 0, "mlstm")
        calls = []
        real = X.checkpoint
        monkeypatch.setattr(X, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
        x = torch.from_numpy(randn(np.random.default_rng(3), 1, 256, tm.cfg.d_model))
        with torch.no_grad():
            plain, _ = X.mlstm_fwd(tl, x, X.mlstm_state(1, tm.cfg.n_heads, tm.dh), tm.cfg.norm_eps)
        assert calls == []
        xr = x.clone().requires_grad_(True)
        seg, _ = X.mlstm_fwd(tl, xr, X.mlstm_state(1, tm.cfg.n_heads, tm.dh), tm.cfg.norm_eps)
        assert len(calls) == 2
        seg.sum().backward()
        assert torch.equal(seg.detach(), plain) and torch.isfinite(xr.grad).all()


class TestXLSTMLM:
    @pytest.mark.parametrize("which,s", [("pair", 12), ("pair_vocab500", 12), ("pair", 256),
                                         ("pair_vocab500", 256)])
    def test_forward_logits(self, which, s, request):
        """At 256 tokens under autograd the recurrences run segmented_scan's
        checkpointed branch (and, for the remat pair, each unit's checkpoint)."""
        jm, jp, tm, tp = request.getfixturevalue(which)
        tok = tokens(np.random.default_rng(s), tm.cfg, 2, s)
        want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(tok)})
        grad = s == 256
        params = jax.tree.map(lambda t: t.detach().requires_grad_(grad), tp)
        with torch.set_grad_enabled(grad):
            got, aux = tm.forward(params, {"tokens": torch.from_numpy(tok)})
        assert got.shape == (2, s, tm.cfg.padded_vocab) and float(aux) == 0.0
        assert got.requires_grad == grad
        close(got, want)
        if tm.cfg.padded_vocab != tm.cfg.vocab:
            assert (got[..., tm.cfg.vocab:] == -1e30).all()

    @pytest.mark.parametrize("which", ["pair", "pair_vocab500"])
    def test_loss_and_grads_match_jax_grad(self, which, request):
        """The loss within 1e-5 and each leaf's gradient within 1e-4 of its
        norm, relative (masked labels not scored)."""
        jm, jp, tm, tp = request.getfixturevalue(which)
        rng = np.random.default_rng(5)
        tok = tokens(rng, tm.cfg, 2, 12)
        labels = tokens(rng, tm.cfg, 2, 12)
        labels[0, :3] = -1
        jloss, _, jgrads = jax_loss_and_grads(
            jm, jp, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)})
        params = jax.tree.map(lambda t: t.detach().clone(), tp)
        loss, metrics, grads = loss_and_grads(
            tm, params, {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(labels)})
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        assert float(metrics["tokens"]) == 21.0
        got = to_jax_layout(grads, tm.cfg)
        want = jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), jax.tree_util.keystr(path)

    def test_decode_steps_match_the_reference(self, pair):
        """Six decode steps: the logits and every state equal the reference's
        step by step."""
        jm, jp, tm, tp = pair
        tok = tokens(np.random.default_rng(6), tm.cfg, 3, 6)
        cache_j, cache_t = jm.init_cache(3, 6), tm.init_cache(3, 6)
        step = jax.jit(jm.decode_step)
        for t in range(6):
            want, cache_j = step(jp, cache_j, jnp.asarray(tok[:, t: t + 1]))
            with torch.no_grad():
                got, cache_t = tm.decode_step(tp, cache_t, torch.from_numpy(tok[:, t: t + 1]))
            close(got, want)
        assert cache_t["index"] == int(cache_j["index"]) == 6
        for kind in ("mlstm", "slstm"):
            for k, t in cache_t["states"][kind].items():
                assert t.shape == cache_j["states"][kind][k].shape
                close(t, cache_j["states"][kind][k])

    def test_forward_equals_teacher_forced_decode(self, pair_vocab500):
        """Within the port, the reference's strongest check: teacher-forced
        decode reproduces the forward's logits."""
        _, _, tm, tp = pair_vocab500
        tok = torch.from_numpy(tokens(np.random.default_rng(7), tm.cfg, 2, 20))
        with torch.no_grad():
            full, _ = tm.forward(tp, {"tokens": tok})
            cache = tm.init_cache(2, 20)
            steps = []
            for t in range(20):
                logits, cache = tm.decode_step(tp, cache, tok[:, t: t + 1])
                steps.append(logits)
        close(torch.cat(steps, dim=1), full.numpy())


def test_launcher_trains_the_reduced_xlstm(tmp_path, capsys):
    rc = launch_train.main(["--arch", NAME, "--device", "cpu", "--steps", "12",
                            "--log-every", "4", "--ckpt-every", "6", "--seq-len", "32",
                            "--ckpt-dir", str(tmp_path)])
    assert rc == 0
    assert "done: first logged loss" in capsys.readouterr().out
    assert Checkpointer(tmp_path).latest_step() == 12
