"""``repro_torch.models.DecoderLM`` against the reference's ``DecoderLM`` from
converted parameters, fp32 on the CPU: logits atol 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import DecoderLM, ModelOptions, WhisperLM, XLSTMLM, build_model

ATOL = 1e-4
FP32 = ModelOptions(param_dtype="float32", compute_dtype="float32")
N_PAGES, PS, MAX_BLOCKS = 12, 4, 6


def make_pair(cfg_j, cfg_t, seed=0):
    jm = jax_build_model(cfg_j, JaxOptions(compute_dtype="float32", remat=False))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg_t, FP32, device="cpu")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), cfg_t, torch.float32, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module")
def pair():
    return make_pair(jax_get_config("glm4-9b").reduced(), get_config("glm4-9b").reduced())


#: reduced configurations with their published GQA group kept (the reduced
#: config's 4 heads share 4 kv heads): granite-8b 32:8 (and rope_theta 1e7),
#: phi4-mini-3.8b 24:8, an odd group of 3
GQA_KEPT = {"granite-8b": dict(n_heads=8, n_kv_heads=2),
            "phi4-mini-3.8b": dict(n_heads=6, n_kv_heads=2)}


def reduced_pair(name: str):
    cj, ct = (dataclasses.replace(get(name).reduced(), **GQA_KEPT.get(name, {}))
              for get in (jax_get_config, get_config))
    return make_pair(cj, ct, seed=2)


@pytest.fixture(scope="module")
def pair_granite():
    return reduced_pair("granite-8b")


@pytest.fixture(scope="module")
def pair_phi4():
    return reduced_pair("phi4-mini-3.8b")


@pytest.fixture(scope="module")
def pair_vocab500():
    """vocab 500 pads to 512: the logits mask is live."""
    cj = dataclasses.replace(jax_get_config("glm4-9b").reduced(), vocab=500)
    ct = dataclasses.replace(get_config("glm4-9b").reduced(), vocab=500)
    return make_pair(cj, ct, seed=1)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


class TestConfigs:
    @pytest.mark.parametrize("name", sorted(ARCHS))
    def test_config_and_reduced_equal_the_reference(self, name):
        a, b = get_config(name), jax_get_config(name)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert dataclasses.asdict(a.reduced()) == dataclasses.asdict(b.reduced())
        assert a.param_count() == b.param_count() and a.padded_vocab == b.padded_vocab

    def test_glm4_9b_published_widths(self):
        c = get_config("glm4-9b")
        assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.resolved_head_dim, c.d_ff,
                c.vocab) == (40, 4096, 32, 2, 128, 13696, 151552)
        assert abs(c.param_count() / 1e9 - 9.40) < 0.01

    def test_unknown_arch(self):
        with pytest.raises(KeyError, match="unknown arch"):
            get_config("nope")


class TestConvert:
    def test_round_trip_leaf_for_leaf(self, pair):
        _, jp, tm, tp = pair
        assert len(tp["layers"]) == tm.cfg.n_layers
        for i, lp in enumerate(tp["layers"]):
            for group in ("attn", "mlp"):
                for name, w in lp[group].items():
                    close(w, jp["layers"][group][name][i], atol=0)
            for norm in ("attn_norm", "ffn_norm"):
                close(lp[norm]["norm_scale"], jp["layers"][norm]["norm_scale"][i], atol=0)
        close(tp["embed"]["tokens"], jp["embed"]["tokens"], atol=0)
        close(tp["lm_head"], jp["lm_head"], atol=0)
        close(tp["final_norm"]["norm_scale"], jp["final_norm"]["norm_scale"], atol=0)

    def test_structure_equals_init(self, pair):
        """Converted parameters have the structure, shapes and dtypes of the
        port's own ``init``."""
        _, _, tm, tp = pair
        own = tm.init(torch.Generator().manual_seed(0))

        def sig(tree):
            if isinstance(tree, dict):
                return {k: sig(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [sig(v) for v in tree]
            return (tuple(tree.shape), tree.dtype)

        assert sig(own) == sig(tp)

    def test_weights_cast_norm_scales_stay_fp32(self, pair):
        _, jp, tm, _ = pair
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg, torch.bfloat16, "cpu")
        assert tp["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
        assert tp["embed"]["tokens"].dtype == torch.bfloat16
        assert tp["layers"][0]["attn_norm"]["norm_scale"].dtype == torch.float32
        assert tp["final_norm"]["norm_scale"].dtype == torch.float32

    def test_layer_count_mismatch_raises(self, pair):
        _, jp, tm, _ = pair
        with pytest.raises(ValueError, match="layers"):
            from_jax_params(jax.tree.map(np.asarray, jp),
                            dataclasses.replace(tm.cfg, n_layers=3))

    def test_default_device_is_the_card(self, pair, monkeypatch):
        """Without ``device`` the weights go to the card; a machine without
        one raises instead of falling back to the CPU."""
        _, jp, tm, _ = pair
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="cuda"):
            from_jax_params(jax.tree.map(np.asarray, jp), tm.cfg)


def _prefill_both(jm, jp, tm, tp, prompt, bucket, table):
    padded = np.zeros((1, bucket), np.int32)
    padded[0, : len(prompt)] = prompt
    pages_j = jm.init_paged_cache(N_PAGES, PS)
    pages_t = tm.init_paged_cache(N_PAGES, PS)
    want, pages_j = jm.prefill_paged(jp, pages_j, jnp.asarray(table), jnp.int32(len(prompt)),
                                     jnp.asarray(padded))
    with torch.no_grad():
        got, pages_t = tm.prefill_paged(tp, pages_t, torch.from_numpy(table), len(prompt),
                                        torch.from_numpy(padded))
    return got, want, pages_t, pages_j


class TestLogitsParity:
    @pytest.mark.parametrize("which", ["pair", "pair_vocab500", "pair_granite", "pair_phi4"])
    def test_prefill_paged(self, which, request):
        jm, jp, tm, tp = request.getfixturevalue(which)
        rng = np.random.default_rng(0)
        prompt = rng.integers(0, tm.cfg.vocab, 6)
        table = np.array([7, 2, -1, -1, -1, -1], np.int32)
        got, want, pages_t, pages_j = _prefill_both(jm, jp, tm, tp, prompt, 8, table)
        assert got.shape == (1, 8, tm.cfg.padded_vocab)
        close(got[0, :6], np.asarray(want)[0, :6])
        for n in ("k", "v"):
            close(pages_t[n][:, :N_PAGES], pages_j[n])
        assert int(got[0, 5].argmax()) == int(np.asarray(want)[0, 5].argmax())

    @pytest.mark.parametrize("which", ["pair", "pair_vocab500", "pair_granite", "pair_phi4"])
    def test_decode_step_paged_after_prefill(self, which, request):
        jm, jp, tm, tp = request.getfixturevalue(which)
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, tm.cfg.vocab, 7)
        tables = np.full((3, MAX_BLOCKS), -1, np.int32)
        tables[1, :3] = [5, 0, 9]
        _, _, pages_t, pages_j = _prefill_both(jm, jp, tm, tp, prompt, 8, tables[1])
        active = np.array([False, True, False])
        for step in range(3):   # crosses a page boundary at position 8
            lengths = np.array([0, 7 + step, 0], np.int32)
            tokens = rng.integers(0, tm.cfg.vocab, (3, 1)).astype(np.int32)
            want, pages_j = jm.decode_step_paged(
                jp, pages_j, jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(tokens),
                jnp.asarray(active))
            with torch.no_grad():
                got, pages_t = tm.decode_step_paged(
                    tp, pages_t, torch.from_numpy(tables), torch.from_numpy(lengths),
                    torch.from_numpy(tokens), torch.from_numpy(active))
            close(got[1], np.asarray(want)[1])
        for n in ("k", "v"):
            close(pages_t[n][:, :N_PAGES], pages_j[n])

    @pytest.mark.parametrize("which", ["pair", "pair_vocab500", "pair_granite", "pair_phi4"])
    def test_decode_step_dense(self, which, request):
        jm, jp, tm, tp = request.getfixturevalue(which)
        rng = np.random.default_rng(2)
        cache_j, cache_t = jm.init_cache(2, 8), tm.init_cache(2, 8)
        for _ in range(4):
            tokens = rng.integers(0, tm.cfg.vocab, (2, 1)).astype(np.int32)
            want, cache_j = jm.decode_step(jp, cache_j, jnp.asarray(tokens))
            with torch.no_grad():
                got, cache_t = tm.decode_step(tp, cache_t, torch.from_numpy(tokens))
            close(got, want)
        assert cache_t["index"] == int(cache_j["index"]) == 4
        close(cache_t["kv"]["k"], cache_j["kv"]["k"])

    def test_padded_vocab_is_masked(self, pair_vocab500):
        _, _, tm, tp = pair_vocab500
        assert (tm.cfg.vocab, tm.cfg.padded_vocab) == (500, 512)
        with torch.no_grad():
            logits = tm.logits(tp, torch.randn(1, 2, tm.cfg.d_model))
        assert (logits[..., 500:] == -1e30).all() and (logits[..., :500] > -1e29).all()

    def test_paged_prefill_then_decode_equals_dense_decode(self, pair):
        """Within the port: prompt through prefill_paged + paged decode gives the
        logits of token-by-token dense decode."""
        _, _, tm, tp = pair
        rng = np.random.default_rng(3)
        prompt = rng.integers(0, tm.cfg.vocab, 5).astype(np.int32)
        nxt = np.array([[11]], np.int32)
        with torch.no_grad():
            cache = tm.init_cache(1, 8)
            for t in list(prompt) + [int(nxt[0, 0])]:
                dense, cache = tm.decode_step(tp, cache, torch.tensor([[t]]))
            pages = tm.init_paged_cache(N_PAGES, PS)
            table = torch.tensor([[3, 1, -1, -1, -1, -1]], dtype=torch.int32)
            padded = np.zeros((1, 8), np.int32)
            padded[0, :5] = prompt
            tm.prefill_paged(tp, pages, table[0], 5, torch.from_numpy(padded))
            paged, _ = tm.decode_step_paged(tp, pages, table, torch.tensor([5]),
                                            torch.from_numpy(nxt), torch.tensor([True]))
        close(paged, dense.numpy())


class TestBuildModel:
    @pytest.mark.parametrize("name", ["xlstm-350m", "whisper-tiny"])
    def test_families_not_ported_raise_naming_the_roadmap(self, name):
        """The two families that raised here until they were ported (the
        name is kept) now build as their own models, on the device asked for."""
        model = build_model(get_config(name).reduced(), device="cpu")
        assert type(model) is {"xlstm-350m": XLSTMLM, "whisper-tiny": WhisperLM}[name]
        assert model.device == torch.device("cpu")

    def test_decoder_lm_refuses_other_families(self):
        with pytest.raises(ValueError, match="does not serve family"):
            DecoderLM(get_config("zamba2-2.7b").reduced(), device="cpu")

    @pytest.mark.parametrize("name", ["dbrx-132b", "qwen3-moe-235b-a22b", "phi-3-vision-4.2b"])
    def test_moe_and_vlm_configs_build_and_step(self, name):
        """Both families build as ``DecoderLM``: a forward (a VLM with its
        patch prefix, scored at the token positions only), a decode step, and
        the MoE's aux loss."""
        cfg = get_config(name).reduced()
        model = build_model(cfg, FP32, device="cpu")
        assert isinstance(model, DecoderLM)
        params = model.init(torch.Generator().manual_seed(0))
        assert ("moe" in params["layers"][0]) == cfg.is_moe
        assert ("patch_proj" in params) == (cfg.family == "vlm")
        batch = {"tokens": torch.zeros(2, 8, dtype=torch.int32)}
        if cfg.family == "vlm":
            batch["patches"] = torch.randn(2, cfg.n_patches, cfg.d_model)
        with torch.no_grad():
            logits, aux = model.forward(params, batch)
            step, _ = model.decode_step(params, model.init_cache(2, 4),
                                        torch.zeros(2, 1, dtype=torch.int32))
        assert logits.shape == (2, 8, cfg.padded_vocab) and torch.isfinite(logits).all()
        assert step.shape == (2, 1, cfg.padded_vocab) and torch.isfinite(step).all()
        assert (float(aux) > 0) == cfg.is_moe

    @pytest.mark.parametrize("name", ["granite-8b", "minicpm-2b", "glm4-9b", "phi4-mini-3.8b"])
    def test_dense_configs_build_and_step(self, name):
        cfg = get_config(name).reduced()
        model = build_model(cfg, FP32, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        with torch.no_grad():
            logits, cache = model.decode_step(params, model.init_cache(2, 4),
                                              torch.zeros(2, 1, dtype=torch.int32))
        assert logits.shape == (2, 1, cfg.padded_vocab) and torch.isfinite(logits[..., :cfg.vocab]).all()
        assert ("lm_head" in params) == (not cfg.tie_embeddings)

    def test_cuda_is_the_default_and_is_not_silently_replaced(self):
        """Entry points run on the card unless asked for the CPU; where there
        is no card they raise instead of carrying on on the CPU."""
        if torch.cuda.is_available():
            assert build_model(get_config("glm4-9b").reduced()).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build_model(get_config("glm4-9b").reduced())

    def test_default_options_hold_weights_once_in_bf16(self):
        model = build_model(get_config("glm4-9b").reduced(), device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        assert params["layers"][0]["mlp"]["w_in"].dtype == torch.bfloat16
        assert params["layers"][0]["ffn_norm"]["norm_scale"].dtype == torch.float32
        assert model.init_paged_cache(4, 2)["k"].shape == (
            model.cfg.n_layers, 5, 2, model.cfg.n_kv_heads, model.cfg.resolved_head_dim)
