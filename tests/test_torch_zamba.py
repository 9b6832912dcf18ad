"""``repro_torch.models.zamba`` against the reference's ``models/zamba.py`` from
converted parameters, fp32 on the CPU, on the same numpy inputs: the reduced
zamba2 configuration (4 layers in 2 units, d_model 64, 4 SSM heads of 32,
N 16, ring window 64).  Tolerance: atol 1e-4 on logits and module outputs
(sums of a few hundred fp32 terms taken in another order)."""

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
from repro.models import zamba as JZ
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_layout
from repro_torch.models import ModelOptions, ZambaLM, build_model
from repro_torch.models import layers as L
from repro_torch.models import zamba as Z

ATOL = 1e-4
FP32 = ModelOptions(param_dtype="float32", compute_dtype="float32")
NAME = "zamba2-2.7b"


def make_pair(cfg_j, cfg_t, seed=0):
    jm = jax_build_model(cfg_j, JaxOptions(compute_dtype="float32", remat=False))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg_t, FP32, device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg_t, torch.float32, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def pair():
    return make_pair(jax_get_config(NAME).reduced(), get_config(NAME).reduced())


@pytest.fixture(scope="module")
def pair_vocab500():
    """vocab 500 pads to 512: the logits mask is live."""
    cj = dataclasses.replace(jax_get_config(NAME).reduced(), vocab=500)
    ct = dataclasses.replace(get_config(NAME).reduced(), vocab=500)
    return make_pair(cj, ct, seed=1)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


def both(a: np.ndarray):
    return jnp.asarray(a), torch.from_numpy(a)


def layer_params(jp, tp, i):
    """Mamba2 layer i of both models (the reference stacks (unit, layer))."""
    ae = len(tp["layers"]) // np.asarray(jp["units"]["ssm"]["w_in"]).shape[0]
    return jax.tree.map(lambda a: a[i // ae, i % ae], jp["units"]), tp["layers"][i]


def tokens(rng, cfg, b, s):
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


class TestConfig:
    def test_published_widths(self):
        c = get_config(NAME)
        assert (c.n_layers, c.d_model, c.ssm_heads, c.ssm_expand * c.d_model // c.ssm_heads,
                c.ssm_state, c.n_heads, c.n_kv_heads, c.resolved_head_dim, c.d_ff, c.vocab,
                c.attn_every, c.long_context_window) == (
                54, 2560, 80, 64, 64, 32, 32, 80, 10240, 32000, 6, 4096)
        assert c.param_count() == jax_get_config(NAME).param_count()

    def test_reduced_shape(self, pair):
        _, _, tm, _ = pair
        c = tm.cfg
        assert (c.n_layers, tm.n_units, c.d_model, tm.ssm_heads, c.ssm_state,
                c.long_context_window) == (4, 2, 64, 4, 16, 64)

    def test_build_model_returns_zamba(self):
        model = build_model(get_config(NAME).reduced(), device="cpu")
        assert isinstance(model, ZambaLM) and model.device == torch.device("cpu")

    def test_cuda_is_the_default_and_is_not_silently_replaced(self):
        if torch.cuda.is_available():
            assert build_model(get_config(NAME).reduced()).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build_model(get_config(NAME).reduced())


class TestConvert:
    def test_round_trip_leaf_for_leaf(self, pair):
        _, jp, tm, tp = pair
        assert len(tp["layers"]) == tm.cfg.n_layers
        for i in range(tm.cfg.n_layers):
            jl, tl = layer_params(jp, tp, i)
            for name, w in tl["ssm"].items():
                close(w, jl["ssm"][name], atol=0)
            close(tl["norm"]["norm_scale"], jl["norm"]["norm_scale"], atol=0)
        for group in ("attn", "mlp"):
            for name, w in tp["shared"][group].items():
                close(w, jp["shared"][group][name], atol=0)
        for norm in ("attn_norm", "mlp_norm"):
            close(tp["shared"][norm]["norm_scale"], jp["shared"][norm]["norm_scale"], atol=0)
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

    def test_bf16_weights_keep_scales_and_ssm_constants_exact(self, pair):
        _, jp, tm, _ = pair
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, torch.bfloat16, "cpu")
        ssm = tp["layers"][3]["ssm"]
        assert ssm["w_in"].dtype == ssm["conv_w"].dtype == tp["lm_head"].dtype == torch.bfloat16
        for name in ("A_log", "D", "dt_bias"):
            assert ssm[name].dtype == torch.float32
            close(ssm[name], jp["units"]["ssm"][name][1, 1], atol=0)
        assert tp["shared"]["attn_norm"]["norm_scale"].dtype == torch.float32

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_to_jax_layout_inverts_the_converter(self, pair, dtype):
        """``to_jax_layout`` gives back the reference's tree, units stacked
        (n_units, attn_every, ...), leaf for leaf (bf16 weights: their bf16
        values, the norm scales and Mamba2 constants exact)."""
        _, jp, tm, _ = pair
        want = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
        got = to_jax_layout(from_jax_params(want, tm.cfg, dtype, "cpu"), tm.cfg)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
            name = jax.tree_util.keystr(path)
            assert g.shape == w.shape and g.dtype == np.float32, name
            exact = dtype == torch.float32 or name.endswith(("['norm_scale']", "['A_log']",
                                                            "['D']", "['dt_bias']"))
            expect = w if exact else torch.from_numpy(w).to(dtype).float().numpy()
            np.testing.assert_array_equal(g, expect, err_msg=name)

    def test_to_jax_layout_of_the_hybrid_needs_its_config(self, pair):
        _, _, _, tp = pair
        with pytest.raises(ValueError, match="attn_every"):
            to_jax_layout(tp)

    def test_layer_count_mismatch_raises(self, pair):
        _, jp, tm, _ = pair
        with pytest.raises(ValueError, match="units"):
            from_jax_params(jax.tree.map(np.asarray, jp),
                            dataclasses.replace(tm.cfg, n_layers=6, attn_every=3))

    def test_default_device_is_the_card(self, pair, monkeypatch):
        _, jp, tm, _ = pair
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg)


class TestMamba2:
    @pytest.mark.parametrize("with_tail", [False, True])
    def test_causal_conv(self, with_tail):
        rng = np.random.default_rng(0)
        xj, xt = both(rng.standard_normal((2, 7, 12)).astype(np.float32))
        wj, wt = both(rng.standard_normal((Z.CONV_K, 12)).astype(np.float32))
        tail = rng.standard_normal((2, Z.CONV_K - 1, 12)).astype(np.float32) if with_tail else None
        out_j, tail_j = JZ._causal_conv(xj, wj, None if tail is None else jnp.asarray(tail))
        out_t, tail_t = Z._causal_conv(xt, wt, None if tail is None else torch.from_numpy(tail))
        close(out_t, out_j, atol=1e-6)
        close(tail_t, tail_j, atol=0)

    @pytest.mark.parametrize("s", [5, 8, 13, 16, 21])   # below, at and above chunk 8
    def test_mamba2_fwd(self, pair, s):
        _, jp, tm, tp = pair
        jl, tl = layer_params(jp, tp, 1)
        xj, xt = both(np.random.default_rng(s).standard_normal((2, s, tm.cfg.d_model))
                      .astype(np.float32))
        want = JZ.mamba2_fwd(jl, xj, tm.cfg.norm_eps, chunk=8)
        with torch.no_grad():
            got = Z.mamba2_fwd(tl, xt, tm.cfg.norm_eps, chunk=8)
        assert got.shape == (2, s, tm.cfg.d_model)
        close(got, want)

    def test_mamba2_fwd_default_chunk(self, pair):
        """The model's own chunk (128): 150 tokens are two chunks, the second
        padded."""
        _, jp, tm, tp = pair
        jl, tl = layer_params(jp, tp, 2)
        xj, xt = both(np.random.default_rng(9).standard_normal((1, 150, tm.cfg.d_model))
                      .astype(np.float32))
        with torch.no_grad():
            close(Z.mamba2_fwd(tl, xt, tm.cfg.norm_eps), JZ.mamba2_fwd(jl, xj, tm.cfg.norm_eps))

    def test_mamba2_step(self, pair):
        _, jp, tm, tp = pair
        jl, tl = layer_params(jp, tp, 0)
        rng = np.random.default_rng(1)
        H, P, N = tm.ssm_heads, tm.d_in // tm.ssm_heads, tm.cfg.ssm_state
        Sj, St = both(rng.standard_normal((3, H, P, N)).astype(np.float32))
        cj, ct = both(rng.standard_normal((3, Z.CONV_K - 1, tm.d_in + 2 * N)).astype(np.float32))
        for step in range(3):
            xj, xt = both(rng.standard_normal((3, 1, tm.cfg.d_model)).astype(np.float32))
            yj, Sj, cj = JZ.mamba2_step(jl, xj, Sj, cj, tm.cfg.norm_eps)
            with torch.no_grad():
                yt, St, ct = Z.mamba2_step(tl, xt, St, ct, tm.cfg.norm_eps)
            close(yt, yj)
            close(St, Sj)
            close(ct, cj)

    def test_step_by_step_equals_the_chunked_forward(self, pair):
        """Within the port: the recurrent step reproduces the chunked scan."""
        _, _, tm, tp = pair
        tl = tp["layers"][3]
        x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 19, tm.cfg.d_model))
                             .astype(np.float32))
        H, P, N = tm.ssm_heads, tm.d_in // tm.ssm_heads, tm.cfg.ssm_state
        S = torch.zeros(2, H, P, N)
        tail = torch.zeros(2, Z.CONV_K - 1, tm.d_in + 2 * N)
        with torch.no_grad():
            full = Z.mamba2_fwd(tl, x, tm.cfg.norm_eps, chunk=8)
            for t in range(19):
                y, S, tail = Z.mamba2_step(tl, x[:, t: t + 1], S, tail, tm.cfg.norm_eps)
                close(y[:, 0], full[:, t].numpy())


class TestAttentionFwd:
    @pytest.mark.parametrize("n_heads,n_kv,causal", [(4, 4, True), (4, 2, True), (4, 1, False)])
    def test_matches_reference(self, n_heads, n_kv, causal):
        rng = np.random.default_rng(n_kv)
        d, hd, s = 32, 16, 11
        p = {"wq": rng.standard_normal((d, n_heads * hd)), "wk": rng.standard_normal((d, n_kv * hd)),
             "wv": rng.standard_normal((d, n_kv * hd)), "wo": rng.standard_normal((n_heads * hd, d))}
        p = {k: (v * 0.2).astype(np.float32) for k, v in p.items()}
        xj, xt = both(rng.standard_normal((2, s, d)).astype(np.float32))
        kw = dict(n_heads=n_heads, n_kv_heads=n_kv, head_dim=hd, rope_theta=1e4, causal=causal)
        want = JL.attention_fwd({k: jnp.asarray(v) for k, v in p.items()}, xj,
                                jnp.arange(s)[None], **kw)
        with torch.no_grad():
            got = L.attention_fwd({k: torch.from_numpy(v) for k, v in p.items()}, xt,
                                  torch.arange(s)[None], **kw)
        close(got, want)

    @pytest.mark.parametrize("use_rope", [True, False])
    def test_kv_override_and_no_rope(self, use_rope):
        """Cross-attention (projected k/v given, no RoPE) and absolute-position
        self-attention, as the reference has them."""
        rng = np.random.default_rng(7)
        d, hd, s, sk = 32, 16, 6, 9
        p = {n: (rng.standard_normal(shape) * 0.2).astype(np.float32) for n, shape in
             (("wq", (d, 2 * hd)), ("wk", (d, 2 * hd)), ("wv", (d, 2 * hd)), ("wo", (2 * hd, d)))}
        xj, xt = both(rng.standard_normal((1, s, d)).astype(np.float32))
        kj, kt = both(rng.standard_normal((1, sk, 2, hd)).astype(np.float32))
        vj, vt = both(rng.standard_normal((1, sk, 2, hd)).astype(np.float32))
        kw = dict(n_heads=2, n_kv_heads=2, head_dim=hd, causal=False, use_rope=use_rope)
        pj, pt = {k: jnp.asarray(v) for k, v in p.items()}, {k: torch.from_numpy(v) for k, v in p.items()}
        want = JL.attention_fwd(pj, xj, jnp.arange(s)[None], kv_override=(kj, vj), **kw)
        with torch.no_grad():
            got = L.attention_fwd(pt, xt, torch.arange(s)[None], kv_override=(kt, vt), **kw)
            close(got, want)
            close(L.attention_fwd(pt, xt, torch.arange(s)[None], **kw),
                  JL.attention_fwd(pj, xj, jnp.arange(s)[None], **kw))


class TestZambaLM:
    @pytest.mark.parametrize("which", ["pair", "pair_vocab500"])
    def test_forward_logits(self, which, request):
        jm, jp, tm, tp = request.getfixturevalue(which)
        tok = tokens(np.random.default_rng(0), tm.cfg, 2, 140)   # two chunks of 128, padded
        want, _ = jm.forward(jp, {"tokens": jnp.asarray(tok)})
        with torch.no_grad():
            got, aux = tm.forward(tp, {"tokens": torch.from_numpy(tok)})
        assert got.shape == (2, 140, tm.cfg.padded_vocab) and float(aux) == 0.0
        close(got, want)
        if tm.cfg.padded_vocab != tm.cfg.vocab:
            assert (got[..., tm.cfg.vocab:] == -1e30).all()

    def test_decode_steps_wrap_the_ring(self, pair):
        """70 decode steps against a 64-slot ring: logits and every cache
        tensor equal the reference's step by step."""
        jm, jp, tm, tp = pair
        tok = tokens(np.random.default_rng(1), tm.cfg, 2, 70)
        cache_j, cache_t = jm.init_cache(2, 128), tm.init_cache(2, 128)
        assert cache_t["kv"]["k"].shape[2] == tm.kv_len(128) == 64
        step = jax.jit(jm.decode_step)
        for t in range(70):
            want, cache_j = step(jp, cache_j, jnp.asarray(tok[:, t: t + 1]))
            with torch.no_grad():
                got, cache_t = tm.decode_step(tp, cache_t, torch.from_numpy(tok[:, t: t + 1]))
            close(got, want)
        assert cache_t["index"] == int(cache_j["index"]) == 70
        n = tm.cfg.n_layers
        close(cache_t["S"], np.asarray(cache_j["S"]).reshape(n, *cache_t["S"].shape[1:]))
        close(cache_t["conv"], np.asarray(cache_j["conv"]).reshape(n, *cache_t["conv"].shape[1:]))
        close(cache_t["kv"]["k"], cache_j["kv"]["k"])
        np.testing.assert_array_equal(cache_t["kv_pos"].numpy(), np.asarray(cache_j["kv_pos"]))

    def test_forward_equals_teacher_forced_decode(self, pair):
        """Within the port, the reference's strongest check: teacher-forced
        decode reproduces the forward's logits (kernel path vs recurrent path)."""
        _, _, tm, tp = pair
        tok = torch.from_numpy(tokens(np.random.default_rng(2), tm.cfg, 2, 40))
        with torch.no_grad():
            full, _ = tm.forward(tp, {"tokens": tok})
            cache = tm.init_cache(2, 40)
            steps = []
            for t in range(40):
                logits, cache = tm.decode_step(tp, cache, tok[:, t: t + 1])
                steps.append(logits)
        close(torch.cat(steps, dim=1), full.numpy(), atol=2e-4)
