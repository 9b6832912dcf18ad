"""The port's layer functions against the reference's, on the same numpy
inputs, in fp32 on the CPU (atol 1e-5: sums are taken in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

ATOL = 1e-5
H, K, HD, D, FF = 4, 2, 16, 64, 128
ATTN = dict(n_heads=H, n_kv_heads=K, head_dim=HD, rope_theta=10_000.0)


def both(a):
    return jnp.asarray(a), torch.from_numpy(np.asarray(a))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=atol)


def attn_params(rng):
    shapes = {"wq": (D, H * HD), "wk": (D, K * HD), "wv": (D, K * HD), "wo": (H * HD, D)}
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for n, s in shapes.items()}
    return ({n: jnp.asarray(a) for n, a in p.items()},
            {n: torch.from_numpy(a) for n, a in p.items()})


def to_jax_pages(pages_t, n_pages):
    """The port's pool without its spare page, as the reference's pytree."""
    return {n: jnp.asarray(t[:n_pages].numpy()) for n, t in pages_t.items()}


class TestRope:
    @pytest.mark.parametrize("pos_shape", ["per_lane", "shared"])
    def test_apply_rope_matches(self, pos_shape):
        rng = np.random.default_rng(0)
        xj, xt = both(rng.standard_normal((3, 5, H, HD)).astype(np.float32))
        pos = rng.integers(0, 60, (3, 5)) if pos_shape == "per_lane" else np.arange(5)
        pj, pt = both(pos.astype(np.int32))
        close(TL.apply_rope(xt, pt, 10_000.0), JL.apply_rope(xj, pj, 10_000.0))

    def test_rope_rotates_interleaved_pairs(self):
        """Position p rotates (x[2i], x[2i+1]) by p * theta^(-2i/hd); the
        half-split layout would fail this."""
        x = torch.zeros(1, 1, 1, 8)
        x[..., 2] = 1.0   # first element of pair i = 1
        out = TL.apply_rope(x, torch.tensor([[3]]), 100.0)
        ang = 3.0 * 100.0 ** (-2.0 / 8.0)
        want = torch.zeros(8)
        want[2], want[3] = np.cos(ang), np.sin(ang)
        close(out[0, 0, 0], want.numpy(), atol=1e-6)

    def test_rope_keeps_dtype(self):
        x = torch.randn(1, 2, 1, 8).to(torch.bfloat16)
        assert TL.apply_rope(x, torch.arange(2), 1e4).dtype == torch.bfloat16


class TestAttentionScores:
    @pytest.mark.parametrize("sq,sk", [(6, 6), (1, 9)])
    def test_matches_with_repeated_kv(self, sq, sk):
        rng = np.random.default_rng(1)
        qj, qt = both(rng.standard_normal((2, sq, H, HD)).astype(np.float32))
        kj, kt = both(rng.standard_normal((2, sk, K, HD)).astype(np.float32))
        vj, vt = both(rng.standard_normal((2, sk, K, HD)).astype(np.float32))
        mj, mt = both(rng.random((2, 1, sq, sk)) < 0.7)
        mj, mt = mj.at[..., 0].set(True), mt.clone()
        mt[..., 0] = True
        want = JL.attention_scores(qj, JL._repeat_kv(kj, H // K), JL._repeat_kv(vj, H // K), mj,
                                   compute_dtype=jnp.float32)
        # the reference's signature: K/V already repeated to H heads
        close(TL.attention_scores(qt, TL._repeat_kv(kt, H // K), TL._repeat_kv(vt, H // K), mt,
                                  compute_dtype=torch.float32), want)
        # grouped: K/V with their own heads, nothing repeated in memory
        close(TL.attention_scores(qt, kt, vt, mt, compute_dtype=torch.float32), want)

    def test_repeat_kv_matches(self):
        rng = np.random.default_rng(2)
        kj, kt = both(rng.standard_normal((2, 3, K, HD)).astype(np.float32))
        close(TL._repeat_kv(kt, 2), JL._repeat_kv(kj, 2), atol=0)
        assert TL._repeat_kv(kt, 1) is kt

    def test_fully_masked_row_is_finite(self):
        """Mask value -1e30 (not -inf): an inactive lane yields an average of
        v, never NaN, exactly as in the reference."""
        q, k, v = torch.randn(1, 1, H, HD), torch.randn(1, 4, K, HD), torch.randn(1, 4, K, HD)
        out = TL.attention_scores(q, k, v, torch.zeros(1, 1, 1, 4, dtype=torch.bool), torch.float32)
        close(out[0, 0, 0], v[0, :, 0].mean(0).numpy())


class TestDenseDecode:
    def test_attention_decode_matches_over_steps(self):
        rng = np.random.default_rng(3)
        pj, pt = attn_params(rng)
        cache_j = JL.init_kv_cache(2, 8, K, HD, dtype=jnp.float32)
        cache_t = TL.init_kv_cache(2, 8, K, HD, dtype=torch.float32)
        for index in range(4):
            xj, xt = both(rng.standard_normal((2, 1, D)).astype(np.float32))
            want, cache_j = JL.attention_decode(pj, xj, cache_j, jnp.int32(index), **ATTN)
            got, cache_t = TL.attention_decode(pt, xt, cache_t, index, **ATTN)
            close(got, want)
        close(cache_t["k"], cache_j["k"])
        close(cache_t["v"], cache_j["v"])


class TestPagedDecode:
    N_PAGES, PS, MAX_BLOCKS = 6, 4, 3

    def _setup(self, rng):
        pages_t = TL.init_paged_kv(self.N_PAGES, self.PS, K, HD, dtype=torch.float32)
        for t in pages_t.values():   # stale values everywhere, as after recycling
            t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)))
        return pages_t

    def test_matches_with_inactive_lanes_and_unallocated_entries(self):
        rng = np.random.default_rng(4)
        pj, pt = attn_params(rng)
        pages_t = self._setup(rng)
        pages_j = to_jax_pages(pages_t, self.N_PAGES)
        table = np.array([[2, 5, -1], [-1, -1, -1], [0, -1, -1], [4, 1, 3]], np.int32)
        lengths = np.array([5, 0, 3, 9], np.int32)   # lane 2 at 3: last slot of its page
        active = np.array([True, False, True, True])
        xj, xt = both(rng.standard_normal((4, 1, D)).astype(np.float32))
        want, new_j = JL.attention_decode_paged(
            pj, xj, pages_j, jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(active), **ATTN)
        got, new_t = TL.attention_decode_paged(
            pt, xt, pages_t, torch.from_numpy(table), torch.from_numpy(lengths),
            torch.from_numpy(active), **ATTN)
        live = [0, 2, 3]   # an inactive lane's output is never read
        close(got[live], np.asarray(want)[live])
        assert torch.isfinite(got).all()
        assert new_t is pages_t   # updated in place
        for n in ("k", "v"):
            close(new_t[n][: self.N_PAGES], new_j[n])

    def test_active_lane_without_a_page_writes_nothing(self):
        """write_block == -1 (block table not grown yet) drops the write."""
        rng = np.random.default_rng(5)
        _, pt = attn_params(rng)
        pages_t = self._setup(rng)
        before = {n: t[: self.N_PAGES].clone() for n, t in pages_t.items()}
        table = torch.full((1, self.MAX_BLOCKS), -1, dtype=torch.int32)
        TL.attention_decode_paged(pt, torch.randn(1, 1, D), pages_t, table,
                                  torch.tensor([0], dtype=torch.int32), torch.tensor([True]), **ATTN)
        for n in ("k", "v"):
            close(pages_t[n][: self.N_PAGES], before[n].numpy(), atol=0)


class TestPagedPrefill:
    N_PAGES, PS = 5, 4

    @pytest.mark.parametrize("length,bucket", [(6, 8), (8, 8), (1, 8), (11, 16)])
    def test_padded_prompt_matches_and_pages_hold_exactly_length_tokens(self, length, bucket):
        rng = np.random.default_rng(6)
        pj, pt = attn_params(rng)
        pages_t = TL.init_paged_kv(self.N_PAGES, self.PS, K, HD, dtype=torch.float32)
        pages_j = to_jax_pages(pages_t, self.N_PAGES)
        n_blocks = -(-length // self.PS)
        table = np.full(4, -1, np.int32)
        table[:n_blocks] = [3, 0, 4][:n_blocks]
        xj, xt = both(rng.standard_normal((1, bucket, D)).astype(np.float32))
        want, new_j = JL.attention_prefill_paged(
            pj, xj, pages_j, jnp.asarray(table), jnp.int32(length), **ATTN)
        got, new_t = TL.attention_prefill_paged(
            pt, xt, pages_t, torch.from_numpy(table), length, **ATTN)
        close(got, want)
        for n in ("k", "v"):
            close(new_t[n][: self.N_PAGES], new_j[n])
        # exactly `length` slots were written: the rest of the pool is still zero
        written = (new_t["k"][: self.N_PAGES].reshape(-1, K * HD).abs().sum(-1) > 0).sum().item()
        assert written == length

    def test_empty_table_writes_nothing(self):
        """The engine's warm-up prefill (all entries -1) leaves the pool untouched."""
        rng = np.random.default_rng(7)
        _, pt = attn_params(rng)
        pages_t = TL.init_paged_kv(self.N_PAGES, self.PS, K, HD, dtype=torch.float32)
        TL.attention_prefill_paged(pt, torch.randn(1, 8, D), pages_t,
                                   torch.full((4,), -1, dtype=torch.int32), 1, **ATTN)
        assert all(t[: self.N_PAGES].abs().sum() == 0 for t in pages_t.values())


class TestMLPAndNorm:
    def test_mlp_fwd_matches(self):
        rng = np.random.default_rng(8)
        shapes = {"w_gate": (D, FF), "w_in": (D, FF), "w_out": (FF, D)}
        p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
             for n, s in shapes.items()}
        xj, xt = both(rng.standard_normal((2, 3, D)).astype(np.float32))
        want = JL.mlp_fwd({n: jnp.asarray(a) for n, a in p.items()}, xj)
        close(TL.mlp_fwd({n: torch.from_numpy(a) for n, a in p.items()}, xt), want)

    def test_rmsnorm_layer_matches(self):
        rng = np.random.default_rng(9)
        xj, xt = both(rng.standard_normal((2, 3, D)).astype(np.float32))
        sj, st = both((1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32))
        close(TL.rmsnorm({"norm_scale": st}, xt, 1e-5), JL.rmsnorm({"norm_scale": sj}, xj, 1e-5))


class TestInit:
    def test_dense_init_is_truncated_fan_in_normal(self):
        g = torch.Generator().manual_seed(0)
        w = TL.dense_init(g, (256, 512))
        std = 1.0 / np.sqrt(256)
        assert w.shape == (256, 512) and w.dtype == torch.float32
        assert w.abs().max().item() <= 2.0 * std + 1e-7
        # std of a unit normal truncated at +-2 is 0.8796
        assert abs(w.std().item() / std - 0.8796) < 0.01
        assert abs(w.mean().item()) < 0.01 * std * 10

    def test_dense_init_is_seeded_and_casts(self):
        a = TL.dense_init(torch.Generator().manual_seed(1), (8, 8), dtype=torch.bfloat16)
        b = TL.dense_init(torch.Generator().manual_seed(1), (8, 8), dtype=torch.bfloat16)
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)

    def test_in_axis_selects_fan_in(self):
        w = TL.dense_init(torch.Generator().manual_seed(2), (4, 1024, 8), in_axis=1)
        assert w.abs().max().item() <= 2.0 / np.sqrt(1024) + 1e-7
