"""The port's plain kernel versions against the reference's Pallas kernels
(interpret mode) and the reference's own oracles, on the same numpy inputs.

On the CPU ``repro_torch.kernels.ops`` takes the plain PyTorch versions; the
CUDA kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.  Tolerances are the reference's: fp32 1e-5, bf16 2e-2.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as fa_pallas
from repro.kernels.rmsnorm import rmsnorm as rms_pallas
from repro_torch.kernels import ops, ref

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}

FA_GRID = [
    (2, 4, 2, 64, 64, 32, 32, 32),
    (1, 8, 1, 128, 128, 64, 64, 32),   # MQA
    (2, 4, 4, 96, 96, 32, 32, 32),     # MHA, non-pow2 seq
    (1, 2, 2, 32, 128, 32, 32, 64),    # cross-length (prefix cache)
]
RMS_SHAPES = [(4, 128), (2, 16, 256), (512,), (3, 5, 7, 64)]


def make(rng, shape, dtype):
    """One fp32 numpy draw, rounded to ``dtype``, as (jax array, torch tensor)."""
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


def to_np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


class TestFlashAttentionRef:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,hd,bq,bk", FA_GRID)
    def test_matches_pallas_interpret(self, dtype, b, hq, hkv, sq, skv, hd, bq, bk):
        rng = np.random.default_rng(0)
        (qj, qt), (kj, kt), (vj, vt) = (
            make(rng, s, dtype) for s in [(b, hq, sq, hd), (b, hkv, skv, hd), (b, hkv, skv, hd)])
        want = fa_pallas(qj, kj, vj, causal=True, block_q=bq, block_k=bk, interpret=True)
        got = ref.flash_attention_ref(qt, kt, vt, causal=True)
        assert got.dtype == qt.dtype and got.shape == qt.shape
        rtol, atol = TOL[dtype]
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=rtol, atol=atol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,hd,bq,bk", FA_GRID)
    def test_matches_reference_oracle(self, dtype, b, hq, hkv, sq, skv, hd, bq, bk):
        rng = np.random.default_rng(1)
        (qj, qt), (kj, kt), (vj, vt) = (
            make(rng, s, dtype) for s in [(b, hq, sq, hd), (b, hkv, skv, hd), (b, hkv, skv, hd)])
        want = jref.flash_attention_ref(qj, kj, vj, causal=True)
        got = ref.flash_attention_ref(qt, kt, vt, causal=True)
        rtol, atol = TOL[dtype]
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=rtol, atol=atol)

    def test_non_causal(self):
        rng = np.random.default_rng(2)
        (qj, qt), (kj, kt), (vj, vt) = (make(rng, (1, 2, 64, 32), "float32") for _ in range(3))
        want = fa_pallas(qj, kj, vj, causal=False, block_q=32, block_k=32, interpret=True)
        got = ref.flash_attention_ref(qt, kt, vt, causal=False)
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)

    def test_causal_mask_is_exact(self):
        """Future tokens must have exactly zero influence."""
        g = torch.Generator().manual_seed(3)
        q, k, v = (torch.randn(1, 2, 64, 32, generator=g) for _ in range(3))
        out1 = ops.flash_attention(q, k, v, causal=True)
        k2, v2 = k.clone(), v.clone()
        k2[:, :, -1] += 100.0
        v2[:, :, -1] += 100.0
        out2 = ops.flash_attention(q, k2, v2, causal=True)
        torch.testing.assert_close(out1[:, :, :-1], out2[:, :, :-1], rtol=1e-6, atol=1e-6)
        assert not torch.allclose(out1[:, :, -1], out2[:, :, -1])

    @pytest.mark.parametrize("sq", [32, 64, 96])
    @pytest.mark.parametrize("hd", [16, 32])
    @pytest.mark.parametrize("group", [1, 2, 4])
    def test_rows_sum_to_one(self, sq, hd, group):
        """With v = all-ones, output must be ones (softmax rows sum to 1)."""
        g = torch.Generator().manual_seed(4)
        q = torch.randn(1, 2 * group, sq, hd, generator=g)
        k = torch.randn(1, 2, sq, hd, generator=g)
        out = ops.flash_attention(q, k, torch.ones(1, 2, sq, hd), causal=True)
        np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-5, atol=1e-5)

    def test_strided_views_give_the_same_result(self):
        """The model hands (b, s, h, hd) tensors over as transposed views."""
        g = torch.Generator().manual_seed(5)
        q = torch.randn(1, 24, 4, 16, generator=g)
        k = torch.randn(1, 24, 2, 16, generator=g)
        v = torch.randn(1, 24, 2, 16, generator=g)
        out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        want = ops.flash_attention(*(t.transpose(1, 2).contiguous() for t in (q, k, v)))
        torch.testing.assert_close(out, want, rtol=0, atol=0)


class TestRMSNormRef:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", RMS_SHAPES)
    def test_matches_pallas_interpret(self, dtype, shape):
        rng = np.random.default_rng(0)
        xj, xt = make(rng, shape, dtype)
        s = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
        want = rms_pallas(xj, jnp.asarray(s), interpret=True, block_rows=64)
        got = ref.rmsnorm_ref(xt, torch.from_numpy(s))
        assert got.dtype == xt.dtype and got.shape == xt.shape
        rtol, atol = TOL[dtype]
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=rtol, atol=atol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", RMS_SHAPES)
    def test_matches_reference_oracle(self, dtype, shape):
        rng = np.random.default_rng(1)
        xj, xt = make(rng, shape, dtype)
        s = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
        want = jref.rmsnorm_ref(xj, jnp.asarray(s), 1e-6)
        got = ref.rmsnorm_ref(xt, torch.from_numpy(s), 1e-6)
        rtol, atol = TOL[dtype]
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=rtol, atol=atol)

    @pytest.mark.parametrize("rows", [1, 7, 64])
    @pytest.mark.parametrize("d", [32, 128])
    def test_unit_rms(self, rows, d):
        """With scale=1, output rows have RMS 1 (up to eps)."""
        x = torch.randn(rows, d, generator=torch.Generator().manual_seed(rows)) * 5.0
        out = ops.rmsnorm(x, torch.ones(d))
        np.testing.assert_allclose(out.square().mean(-1).sqrt().numpy(), 1.0, rtol=1e-3)


class TestOpsDispatch:
    def test_cpu_tensor_takes_the_plain_version_and_launches_nothing(self):
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(1, 2, 32, 16, generator=g) for _ in range(3))
        x, scale = torch.randn(4, 64, generator=g), torch.rand(64, generator=g)
        ops.reset_launch_counts()
        torch.testing.assert_close(ops.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v),
                                   rtol=0, atol=0)
        torch.testing.assert_close(ops.rmsnorm(x, scale, 1e-5), ref.rmsnorm_ref(x, scale, 1e-5),
                                   rtol=0, atol=0)
        assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0}

    def test_causal_with_more_queries_than_keys_is_rejected(self):
        q = torch.zeros(1, 2, 8, 16)
        kv = torch.zeros(1, 2, 4, 16)
        with pytest.raises(ValueError, match="no visible key"):
            ops.flash_attention(q, kv, kv, causal=True)
        assert ops.flash_attention(q, kv, kv, causal=False).shape == q.shape

    @pytest.mark.parametrize("q,k", [((1, 3, 8, 16), (1, 2, 8, 16)),    # heads do not group
                                     ((1, 2, 8, 16), (2, 2, 8, 16)),    # batch differs
                                     ((1, 2, 8, 16), (1, 2, 8, 32))])   # head_dim differs
    def test_bad_shapes_are_rejected(self, q, k):
        with pytest.raises(ValueError):
            ops.flash_attention(torch.zeros(q), torch.zeros(k), torch.zeros(k))

    def test_cuda_wrappers_refuse_cpu_tensors(self):
        """The kernel wrappers never compute on the CPU: they raise."""
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        from repro_torch.kernels.rmsnorm import rmsnorm_cuda

        with pytest.raises(ValueError, match="CUDA"):
            rmsnorm_cuda(torch.zeros(2, 8), torch.ones(8))
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_cuda(*(torch.zeros(1, 1, 4, 16) for _ in range(3)))
