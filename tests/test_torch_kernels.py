"""The port's plain kernel versions against the reference's Pallas kernels
(interpret mode) and the reference's own oracles, on the same numpy inputs.

On the CPU ``repro_torch.kernels.ops`` takes the plain PyTorch versions; the
CUDA kernels themselves are held against these plain versions on the card by
``chip_smoke.py``.  Tolerances are the reference's: fp32 1e-5, bf16 2e-2; for
the SSD chunk scan its own test's: y at 1e-4 (fp32) or 2e-2 with atol 1e-4
(bf16), S_final at 1e-4, since the chunk products sum over up to 128 terms.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as fa_pallas
from repro.kernels.rmsnorm import rmsnorm as rms_pallas
from repro.kernels.ssd_chunk import ssd_chunk_scan as ssd_pallas
from repro_torch.kernels import flash_attention as fa_cuda
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rms_cuda
from repro_torch.kernels import ssd_chunk as ssd_cuda

TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}

FA_GRID = [
    (2, 4, 2, 64, 64, 32, 32, 32),
    (1, 8, 1, 128, 128, 64, 64, 32),   # MQA
    (2, 4, 4, 96, 96, 32, 32, 32),     # MHA, non-pow2 seq
    (1, 2, 2, 32, 128, 32, 32, 64),    # cross-length (prefix cache)
]
RMS_SHAPES = [(4, 128), (2, 16, 256), (512,), (3, 5, 7, 64)]
SSD_SHAPES = [            # b, H, s, P, N, chunk: the reference's tests/test_kernels.py
    (2, 2, 64, 16, 8, 16),
    (1, 4, 128, 32, 16, 32),
    (2, 1, 32, 8, 8, 32),   # single chunk
]
SSD_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-4)}


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


def ssd_inputs(rng, b, H, s, P, N, dtype):
    """x, B, C in ``dtype`` (B/C scaled by 0.5), dt = softplus(n), loga =
    -softplus(n) in fp32, as the reference's test draws them; each as
    (jax array, torch tensor)."""
    x = make(rng, (b, H, s, P), dtype)
    B, C = (make(rng, (b, H, s, N), dtype) for _ in range(2))
    B, C = ((jb * 0.5, tb * 0.5) for jb, tb in (B, C))
    dt = np.logaddexp(rng.standard_normal((b, H, s)), 0.0).astype(np.float32)
    loga = -np.logaddexp(rng.standard_normal((b, H, s)), 0.0).astype(np.float32)
    return x, B, C, (jnp.asarray(dt), torch.from_numpy(dt)), (jnp.asarray(loga), torch.from_numpy(loga))


class TestSSDChunkRef:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,H,s,P,N,chunk", SSD_SHAPES)
    @pytest.mark.parametrize("fn", ["ref", "ops"])
    def test_matches_pallas_interpret(self, fn, dtype, b, H, s, P, N, chunk):
        args = ssd_inputs(np.random.default_rng(0), b, H, s, P, N, dtype)
        y_want, S_want = ssd_pallas(*(j for j, _ in args), chunk=chunk, interpret=True)
        scan = ref.ssd_chunk_scan_ref if fn == "ref" else ops.ssd_chunk_scan
        y, S = scan(*(t for _, t in args), chunk=chunk)
        assert y.dtype == args[0][1].dtype and y.shape == (b, H, s, P)
        assert S.dtype == torch.float32 and S.shape == (b, H, P, N)
        rtol, atol = SSD_TOL[dtype]
        np.testing.assert_allclose(to_np(y), to_np(y_want), rtol=rtol, atol=atol)
        np.testing.assert_allclose(to_np(S), to_np(S_want), rtol=1e-4, atol=1e-4)

    def test_matches_the_time_step_recurrence(self):
        """The chunked scan equals the per-timestep recurrence (ground truth),
        as in the reference's ``test_matches_model_time_scan``."""
        b, H, s, P, N = 1, 2, 24, 8, 4
        x, B, C, dt, loga = (t.numpy() for _, t in ssd_inputs(np.random.default_rng(7),
                                                               b, H, s, P, N, "float32"))
        S = np.zeros((b, H, P, N), np.float32)
        ys = np.zeros((b, H, s, P), np.float32)
        for t in range(s):
            S = np.exp(loga[:, :, t])[..., None, None] * S + dt[:, :, t][..., None, None] * \
                np.einsum("bhp,bhn->bhpn", x[:, :, t], B[:, :, t])
            ys[:, :, t] = np.einsum("bhpn,bhn->bhp", S, C[:, :, t])
        y_got, S_got = ops.ssd_chunk_scan(*map(torch.from_numpy, (x, B, C, dt, loga)), chunk=8)
        np.testing.assert_allclose(y_got.numpy(), ys, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(S_got.numpy(), S, rtol=1e-4, atol=1e-4)

    def test_single_chunk_equals_ssd_chunk_ref_of_the_reference(self):
        x, B, C, dt, loga = ssd_inputs(np.random.default_rng(3), 1, 1, 16, 8, 4, "float32")
        S0 = np.random.default_rng(4).standard_normal((8, 4)).astype(np.float32)
        y_want, S_want = jref.ssd_chunk_ref(x[0][0, 0], B[0][0, 0], C[0][0, 0], dt[0][0, 0],
                                            loga[0][0, 0], jnp.asarray(S0))
        y, S = ref.ssd_chunk_ref(x[1][0, 0], B[1][0, 0], C[1][0, 0], dt[1][0, 0], loga[1][0, 0],
                                 torch.from_numpy(S0))
        np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(S.numpy(), np.asarray(S_want), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("b,H,s,P,N,chunk", SSD_SHAPES)
    def test_fp32_prefix_sum_matches_pallas_interpret(self, b, H, s, P, N, chunk):
        """``cum_dtype=float32`` is the reference's own arithmetic for the
        prefix sum; at these sizes it agrees with the Pallas kernel as tightly
        as the default fp64 sum does (rtol = atol = 1e-4)."""
        args = ssd_inputs(np.random.default_rng(8), b, H, s, P, N, "float32")
        y_want, S_want = ssd_pallas(*(j for j, _ in args), chunk=chunk, interpret=True)
        y, S = ref.ssd_chunk_scan_ref(*(t for _, t in args), chunk=chunk, cum_dtype=torch.float32)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(S.numpy(), np.asarray(S_want), rtol=1e-4, atol=1e-4)

    def test_model_layout_views_give_the_same_result(self):
        """The model holds x as (b, s, H, P) and B/C as (b, s, N) shared by all
        heads; they go in as a transposed view and head-stride-0 views."""
        g = torch.Generator().manual_seed(5)
        b, s, H, P, N = 2, 64, 3, 8, 4
        x = torch.randn(b, s, H, P, generator=g)
        B, C = torch.randn(b, s, N, generator=g), torch.randn(b, s, N, generator=g)
        dt = torch.rand(b, s, H, generator=g)
        loga = -torch.rand(b, s, H, generator=g)
        Bv, Cv = B[:, None].expand(b, H, s, N), C[:, None].expand(b, H, s, N)
        assert Bv.stride(1) == 0
        got = ops.ssd_chunk_scan(x.transpose(1, 2), Bv, Cv, dt.transpose(1, 2),
                                 loga.transpose(1, 2), chunk=16)
        want = ops.ssd_chunk_scan(x.transpose(1, 2).contiguous(), Bv.contiguous(), Cv.contiguous(),
                                  dt.transpose(1, 2).contiguous(), loga.transpose(1, 2).contiguous(),
                                  chunk=16)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, rtol=0, atol=0)

    def test_output_dtype_can_be_asked_for(self):
        """bf16 inputs, fp32 y (what mamba2_fwd asks for): the same numbers as
        the bf16 default before its last rounding."""
        args = [t for _, t in ssd_inputs(np.random.default_rng(6), 1, 2, 32, 8, 4, "bfloat16")]
        y32, S32 = ops.ssd_chunk_scan(*args, chunk=16, out_dtype=torch.float32)
        y16, S16 = ops.ssd_chunk_scan(*args, chunk=16)
        assert (y32.dtype, y16.dtype) == (torch.float32, torch.bfloat16)
        torch.testing.assert_close(y32.to(torch.bfloat16), y16, rtol=0, atol=0)
        torch.testing.assert_close(S32, S16, rtol=0, atol=0)

    @pytest.mark.parametrize("s,chunk", [(48, 32), (24, 16)])
    def test_sequence_not_a_multiple_of_the_chunk_is_rejected(self, s, chunk):
        x = torch.zeros(1, 2, s, 8)
        B = torch.zeros(1, 2, s, 4)
        dt = torch.zeros(1, 2, s)
        with pytest.raises(ValueError, match="multiple of chunk"):
            ops.ssd_chunk_scan(x, B, B, dt, dt, chunk=chunk)

    def test_chunk_is_capped_at_the_sequence(self):
        x, B, C, dt, loga = (t for _, t in ssd_inputs(np.random.default_rng(8), 1, 1, 24, 4, 4,
                                                      "float32"))
        y, S = ops.ssd_chunk_scan(x, B, C, dt, loga, chunk=128)
        y1, S1 = ops.ssd_chunk_scan(x, B, C, dt, loga, chunk=24)
        torch.testing.assert_close(y, y1, rtol=0, atol=0)
        torch.testing.assert_close(S, S1, rtol=0, atol=0)

    def test_bad_shapes_are_rejected(self):
        x = torch.zeros(1, 2, 16, 8)
        with pytest.raises(ValueError):
            ops.ssd_chunk_scan(x, torch.zeros(1, 3, 16, 4), torch.zeros(1, 3, 16, 4),
                               torch.zeros(1, 2, 16), torch.zeros(1, 2, 16))
        with pytest.raises(ValueError):
            ops.ssd_chunk_scan(x, torch.zeros(1, 2, 16, 4), torch.zeros(1, 2, 16, 4),
                               torch.zeros(1, 2, 15), torch.zeros(1, 2, 16))


def segmented_scan(x, B, C, dt, loga, chunk, G):
    """The tensor-core route's decomposition in plain torch: each (b, h) cut
    into G segments of whole chunks (sizes differing by at most one, as the
    kernel cuts them); pass A runs segments 0 .. G-2 from a zero state for
    their local state and total decay; the scan over segments gives each one
    its incoming state; pass B runs every segment from it for y and S_final."""
    b, H, s, P = x.shape
    N = B.shape[-1]
    n = s // chunk
    bounds = [(k * n // G, (k + 1) * n // G) for k in range(G)]

    def run(c0, c1, S):
        ys = []
        for c in range(c0, c1):
            part = slice(c * chunk, (c + 1) * chunk)
            y, S = ref.ssd_chunk_ref(x[:, :, part], B[:, :, part], C[:, :, part],
                                     dt[:, :, part], loga[:, :, part], S)
            ys.append(y)
        return ys, S

    zero = torch.zeros(b, H, P, N)
    s_loc, decay = [], []
    for c0, c1 in bounds[:-1]:                       # pass A
        s_loc.append(run(c0, c1, zero)[1])
        d = torch.ones(b, H)
        for c in range(c0, c1):
            cum = torch.cumsum(loga[:, :, c * chunk:(c + 1) * chunk].double(), -1).float()
            d = d * torch.exp(cum[..., -1])
        decay.append(d)
    s_in = [zero]                                    # the scan over segments
    for k in range(G - 1):
        s_in.append(s_in[-1] * decay[k][..., None, None] + s_loc[k])
    ys = []
    for k, (c0, c1) in enumerate(bounds):            # pass B
        yk, S = run(c0, c1, s_in[k])
        ys += yk
    return torch.cat(ys, dim=2), S


class TestSSDSegments:
    """The sequence split of the tensor-core route is exact algebra: at any G,
    with or without G dividing the number of chunks, it gives the sequential
    scan up to fp32 rounding and the Pallas kernel at the reference's rule."""

    @pytest.mark.parametrize("G", [1, 2, 3, 5, 8])
    def test_equals_the_sequential_scan(self, G):
        args = [t for _, t in ssd_inputs(np.random.default_rng(11), 1, 2, 256, 8, 4, "float32")]
        y, S = segmented_scan(*args, chunk=32, G=G)
        y_want, S_want = ref.ssd_chunk_scan_ref(*args, chunk=32)
        torch.testing.assert_close(y, y_want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(S, S_want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("G", [2, 3])
    def test_matches_pallas_interpret(self, G, dtype):
        args = ssd_inputs(np.random.default_rng(12), 2, 2, 128, 16, 8, dtype)
        y_want, S_want = ssd_pallas(*(j for j, _ in args), chunk=32, interpret=True)
        y, S = segmented_scan(*(t.float() for _, t in args), chunk=32, G=G)
        rtol, atol = SSD_TOL[dtype]
        np.testing.assert_allclose(to_np(y), to_np(y_want), rtol=rtol, atol=atol)
        np.testing.assert_allclose(to_np(S), to_np(S_want), rtol=1e-4, atol=1e-4)

    def test_a_segment_decay_that_underflows_to_zero_is_exact(self):
        """A segment whose total decay underflows to 0 hands on only its own
        local state: no inf meets the 0, so no NaN."""
        x, B, C, dt, _ = (t for _, t in ssd_inputs(np.random.default_rng(13), 1, 2, 128, 8, 4,
                                                   "float32"))
        loga = torch.full((1, 2, 128), -60.0)   # exp(-60 * 32) is 0 in fp32
        y, S = segmented_scan(x, B, C, dt, loga, chunk=32, G=4)
        y_want, S_want = ref.ssd_chunk_scan_ref(x, B, C, dt, loga, chunk=32)
        assert torch.isfinite(y).all() and torch.isfinite(S).all()
        torch.testing.assert_close(y, y_want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(S, S_want, rtol=1e-5, atol=1e-5)


class TestSSDSplitPrecision:
    """Why the tensor-core route splits each fp32 operand into three bf16
    terms: at a chunk whose prefix sum reaches |cum| ~ 100, W x with W rounded
    once to bf16 misses the 1e-4 rule (rtol = atol) by far; two terms meet it
    with a margin of a few times, three at fp32 level."""

    @staticmethod
    def chunk():
        rng = np.random.default_rng(0)
        cs, P, N = 128, 64, 64
        loga = -np.abs(rng.standard_normal(cs) * 0.5 + 0.78).astype(np.float32)
        dt = np.logaddexp(rng.standard_normal(cs), 0.0).astype(np.float32)
        C, B = (rng.standard_normal((cs, N)).astype(np.float32) * 0.5 for _ in range(2))
        x = rng.standard_normal((cs, P)).astype(np.float32)
        C, B, x = (torch.from_numpy(a).bfloat16().float() for a in (C, B, x))
        cum = torch.cumsum(torch.from_numpy(loga).double(), 0).float()
        gate = torch.where(torch.ones(cs, cs, dtype=torch.bool).tril(),
                           torch.exp(cum[:, None] - cum[None, :]), 0.0)
        W = gate * (C @ B.T) * torch.from_numpy(dt)[None, :]
        return cum, W, x

    @staticmethod
    def terms(v, k):
        out = []
        for _ in range(k):
            out.append(v.bfloat16().float())
            v = v - out[-1]
        return out

    @pytest.mark.parametrize("k,lo,hi", [(1, 1.0, np.inf), (2, 0.0, 0.5), (3, 0.0, 1e-6)])
    def test_terms_against_the_rule(self, k, lo, hi):
        cum, W, x = self.chunk()
        assert cum[-1].abs() > 100
        exact = W.double() @ x.double()
        got = sum(t.double() @ x.double() for t in self.terms(W, k))   # each product exact
        ratio = ((got - exact).abs() / (1e-4 * (1 + exact.abs()))).max().item()
        assert lo < ratio <= hi

    def test_three_terms_sum_to_the_fp32_value(self):
        _, W, _ = self.chunk()
        t0, t1, t2 = self.terms(W, 3)
        assert all(t.bfloat16().float().equal(t) for t in (t0, t1, t2))
        # to fp32's rounding, but for subnormals (below 1.2e-38) that bf16 cannot hold
        torch.testing.assert_close(t0 + t1 + t2, W, rtol=2 ** -23, atol=1e-37)


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
        assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "ssd_chunk_scan": 0,
                                       "rmsnorm_bwd": 0, "flash_attention_bwd": 0,
                                       "ssd_chunk_scan_bwd": 0}

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

    def test_launch_counts_name_every_kernel(self):
        ops.reset_launch_counts()
        assert set(ops.launch_counts()) == {"rmsnorm", "flash_attention", "ssd_chunk_scan",
                                            "rmsnorm_bwd", "flash_attention_bwd",
                                            "ssd_chunk_scan_bwd"}
        x, B = torch.zeros(1, 1, 8, 4), torch.zeros(1, 1, 8, 4)
        ops.ssd_chunk_scan(x, B, B, torch.zeros(1, 1, 8), torch.zeros(1, 1, 8), chunk=4)
        assert ops.launch_counts()["ssd_chunk_scan"] == 0   # CPU: the plain version

    def test_cuda_wrappers_refuse_cpu_tensors(self):
        """The kernel wrappers never compute on the CPU: they raise."""
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        from repro_torch.kernels.rmsnorm import rmsnorm_cuda
        from repro_torch.kernels.ssd_chunk import ssd_chunk_scan_cuda

        with pytest.raises(ValueError, match="CUDA"):
            rmsnorm_cuda(torch.zeros(2, 8), torch.ones(8))
        with pytest.raises(ValueError, match="CUDA"):
            flash_attention_cuda(*(torch.zeros(1, 1, 4, 16) for _ in range(3)))
        with pytest.raises(ValueError, match="CUDA"):
            ssd_chunk_scan_cuda(torch.zeros(1, 1, 8, 4), torch.zeros(1, 1, 8, 4),
                                torch.zeros(1, 1, 8, 4), torch.zeros(1, 1, 8), torch.zeros(1, 1, 8))


# Every flash-attention case of chip_smoke.py's kernels phase:
# (b, hq, hkv, sq, skv, hd, dtype, model layout, offset in elements)
PLAN_FLASH = [
    (1, 32, 32, 32768, 32768, 80, "bfloat16", True, 0),   # zamba2's 32k forward
    (1, 32, 32, 4096, 4096, 80, "bfloat16", True, 0),
    (2, 8, 8, 300, 300, 80, "bfloat16", True, 0),
    (1, 4, 4, 150, 150, 80, "float32", False, 0),
    (1, 4, 2, 130, 130, 80, "bfloat16", False, 1),
    (1, 32, 2, 1024, 1024, 128, "bfloat16", True, 0),     # glm4-9b's largest prefill bucket
    (1, 32, 2, 128, 128, 128, "bfloat16", True, 0),       # and its smallest
    (2, 4, 2, 75, 203, 64, "float32", False, 0),
    (1, 4, 4, 96, 96, 16, "float32", False, 0),
    (2, 4, 2, 75, 203, 64, "bfloat16", False, 0),
    (1, 4, 4, 96, 96, 16, "bfloat16", True, 0),
    (1, 8, 1, 130, 130, 32, "bfloat16", False, 0),
    (1, 8, 2, 200, 200, 128, "bfloat16", False, 1),
    (1, 4, 2, 100, 70, 64, "bfloat16", False, 0),
    (1, 4, 2, 100, 70, 32, "float32", False, 0),
    (4, 36, 36, 1024, 1024, 64, "bfloat16", True, 0),    # minicpm-2b's training step
    (4, 36, 36, 1024, 1024, 64, "float32", True, 0),     # and in the launcher's fp32
    (4, 32, 32, 1600, 1600, 96, "bfloat16", True, 0),    # phi-3-vision's step: 576 patches + 1024
    (4, 32, 32, 1600, 1600, 96, "float32", True, 0),     # and in the launcher's fp32
    (1, 4, 4, 150, 150, 96, "float32", False, 0),        # hd 96, ragged
    (1, 4, 4, 150, 150, 96, "bfloat16", False, 1),       # and unaligned bf16
    (1, 64, 4, 1024, 1024, 128, "bfloat16", True, 0),    # qwen3-moe's prefill, GQA 16:1
    (4, 16, 1, 1024, 1024, 128, "bfloat16", True, 0),    # glm4-9b's step, a rank's shards on (2, 2)
    (4, 24, 4, 1024, 1024, 128, "bfloat16", True, 0),    # dbrx-132b's step, a rank's shards on (2, 2)
    (4, 6, 6, 1500, 1500, 64, "bfloat16", True, 0),      # whisper-tiny's encoder, 1500 frames
    (4, 6, 6, 1500, 1500, 64, "float32", True, 0),       # and in the launcher's fp32
    (4, 6, 6, 448, 1500, 64, "bfloat16", True, 0),       # its cross-attention, 448 over 1500
    (4, 6, 6, 448, 1500, 64, "float32", True, 0),
    (4, 6, 6, 448, 448, 64, "bfloat16", True, 0),        # its decoder's self-attention
    (4, 6, 6, 448, 448, 64, "float32", True, 0),
    (8, 6, 6, 1500, 1500, 64, "bfloat16", True, 0),      # its serving's prefill_cross, 8 lanes
    (2, 6, 6, 448, 24, 64, "bfloat16", True, 0),         # cross-attention over 24 frames
]
# Every RMSNorm case of chip_smoke.py: (shape, dtype)
PLAN_RMS = [
    ((1, 32768, 2560), "bfloat16"),
    ((8, 1, 2560), "bfloat16"),
    ((1, 1024, 4096), "bfloat16"),
    ((8, 1, 4096), "bfloat16"),
    ((3, 37, 1000), "float32"),
    ((5, 4099), "bfloat16"),
    ((1, 1024, 2560), "bfloat16"),
    ((256, 384), "bfloat16"),      # each other vector count of the register route
    ((256, 1024), "bfloat16"),
    ((256, 2304), "bfloat16"),
    ((256, 3072), "bfloat16"),
    ((256, 6144), "bfloat16"),
    ((4, 1024, 2304), "bfloat16"),  # minicpm-2b's training step
    ((4, 1024, 2304), "float32"),
    ((8, 64, 64), "bfloat16"),
    ((4, 256, 1024), "bfloat16"),   # xlstm-350m's training step
    ((8, 1, 1024), "bfloat16"),     # and its decode
    ((4, 1500, 384), "bfloat16"),   # whisper-tiny's encoder
    ((4, 448, 384), "bfloat16"),    # and its decoder
    ((8, 1, 384), "bfloat16"),      # and its decode
    ((4, 1024, 6144), "bfloat16"),  # dbrx-132b's step, a rank's rows on (2, 2)
    ((8, 1, 6144), "bfloat16"),     # its decode: 8 lanes a rank on (1, 4) and one card
    ((4, 1, 6144), "bfloat16"),     # and 4 a rank on (2, 2)
]


def meta_attention(b, hq, hkv, sq, skv, hd, dtype, model_layout, offset):
    """q, k, v and the wrapper's output as storage-free (meta) tensors with the
    strides and element offsets chip_smoke.py gives the kernel; a meta
    tensor's ``data_ptr`` is its byte offset, so alignment shows as on the card."""
    dt = getattr(torch, dtype)

    def make_t(h, s):
        shape = (b, s, h, hd) if model_layout else (b, h, s, hd)
        t = torch.empty(int(np.prod(shape)) + offset, dtype=dt, device="meta")[offset:].view(shape)
        return t.transpose(1, 2) if model_layout else t

    q, k, v = make_t(hq, sq), make_t(hkv, skv), make_t(hkv, skv)
    return q, k, v, fa_cuda._dense_like(q)


class TestFlashPlan:
    """``flash_plan`` is the launch the C entry point validates and runs; here
    it is checked on the CPU for every shape the chip smoke gives the kernel."""

    @pytest.mark.parametrize("case", PLAN_FLASH)
    def test_route(self, case):
        plan = fa_cuda.flash_plan(*meta_attention(*case))
        dtype, offset = case[6], case[8]
        assert plan.route == ("wgmma" if dtype == "bfloat16" and offset == 0 else "cuda_cores")

    @pytest.mark.parametrize("case", PLAN_FLASH)
    def test_grid_covers_every_query_tile(self, case):
        b, hq, sq = case[0], case[1], case[3]
        plan = fa_cuda.flash_plan(*meta_attention(*case))
        assert plan.grid == (-(-sq // plan.bm), hq, b)
        assert (plan.bm, plan.threads) == ((128, 384) if plan.route == "wgmma" else (64, 128))

    @pytest.mark.parametrize("case", PLAN_FLASH)
    def test_shared_memory_fits_a_block(self, case):
        plan = fa_cuda.flash_plan(*meta_attention(*case))
        assert 0 < plan.smem_bytes <= fa_cuda.SMEM_LIMIT

    @pytest.mark.parametrize("case", PLAN_FLASH)
    def test_tensor_maps(self, case):
        b, hq, hkv, sq, skv, hd = case[:6]
        q, k, v, out = meta_attention(*case)
        plan = fa_cuda.flash_plan(q, k, v, out)
        if plan.route != "wgmma":
            assert plan.maps == ()
            return
        for m, t, h, s, rows in zip(plan.maps, (q, k, v), (hq, hkv, hkv), (sq, skv, skv),
                                    (plan.bm, plan.bn, plan.bn)):
            assert m.dims == (hd, s, h, b)
            # the head-dim slabs cover hd exactly, in order
            assert [c for c, _, _ in m.slabs] == [sum(w for _, w, _ in m.slabs[:i])
                                                  for i in range(len(m.slabs))]
            assert sum(w for _, w, _ in m.slabs) == hd
            for _, width, swizzle in m.slabs:
                box = (width, m.box_rows, 1, 1)   # what the C side encodes for the slab
                assert swizzle in (32, 64, 128)
                assert box[0] * 2 <= swizzle and box[0] * 2 % 16 == 0   # inner box within its swizzle span
                assert all(1 <= n <= 256 for n in box) and box[1] == rows
            assert all(st > 0 and st % 16 == 0 for st in m.strides)
            # a dim of size > 1 keeps the tensor's own stride (model layout read without a copy)
            for st, n, elems in zip(m.strides, (s, h, b), (t.stride(2), t.stride(1), t.stride(0))):
                if n > 1:
                    assert st == 2 * elems

    @pytest.mark.parametrize("hd,slabs", [(16, [(0, 16, 32)]), (32, [(0, 32, 64)]),
                                          (64, [(0, 64, 128)]),
                                          (80, [(0, 64, 128), (64, 16, 32)]),
                                          (128, [(0, 64, 128), (64, 64, 128)]),
                                          (96, [(0, 64, 128), (64, 32, 64)])])
    def test_head_dim_slabs(self, hd, slabs):
        assert list(fa_cuda.head_dim_slabs(hd)) == slabs

    @pytest.mark.parametrize("case", PLAN_FLASH[:3] + PLAN_FLASH[16:17])
    def test_plan_array_layout(self, case):
        plan = fa_cuda.flash_plan(*meta_attention(*case))
        values = list(plan.as_array())
        assert len(values) == fa_cuda.PLAN_LEN
        assert values[:9] == [fa_cuda.ROUTES.index(plan.route), plan.bm, plan.bn, plan.stages,
                              plan.threads, *plan.grid, plan.smem_bytes]
        for i, m in enumerate(plan.maps):
            assert values[9 + 16 * i: 9 + 16 * (i + 1)] == m.values()
        if plan.route == "cuda_cores":   # vector_loads in the first map's place
            assert values[9:] == [int(plan.vector_loads)] + [0] * (fa_cuda.PLAN_LEN - 10)

    @pytest.mark.parametrize("case", [c for c in PLAN_FLASH if c[6] == "float32" or c[8]])
    def test_core_walk_covers_every_visible_key_once(self, case):
        """CUDA cores: the grid's query tiles cover every query row once, and
        the K/V tiles a block walks (``bn`` keys from 0 to its causal limit, as
        the C side computes it) cover every key a row of its tile sees, once,
        and walk no tile that none of its rows sees.  The chip smoke runs
        ``sq > skv`` without the causal mask."""
        b, hq, hkv, sq, skv, hd = case[:6]
        causal = sq <= skv
        plan = fa_cuda.flash_plan(*meta_attention(*case))
        assert plan.route == "cuda_cores"
        tiles = [np.arange(q0, min(q0 + plan.bm, sq)) for q0 in range(0, plan.grid[0] * plan.bm,
                                                                      plan.bm)]
        assert np.array_equal(np.concatenate(tiles), np.arange(sq))
        off = skv - sq
        for rows in tiles:
            kv_end = min(skv, rows[-1] + 1 + off) if causal else skv
            starts = range(0, kv_end, plan.bn)
            walked = np.concatenate([np.arange(k0, min(k0 + plan.bn, skv)) for k0 in starts])
            seen = np.arange(skv)[None, :] <= rows[:, None] + off if causal else \
                np.ones((rows.size, skv), bool)
            visible = np.flatnonzero(seen.any(0))
            assert np.array_equal(np.unique(walked), walked)            # each key once
            assert np.isin(visible, walked).all()
            assert all(np.isin(np.arange(k0, k0 + plan.bn), visible).any() for k0 in starts)

    @pytest.mark.parametrize("case", [c for c in PLAN_FLASH if c[6] == "float32" or c[8]])
    def test_core_shared_memory_fits_two_blocks(self, case):
        """The owned Q tile, ``stages`` K/V tiles of ``bn`` keys and the P
        tile, fp32 rows padded, fit two blocks an SM (227 KB a block at most)."""
        hd = case[5]
        plan = fa_cuda.flash_plan(*meta_attention(*case))
        rs, ps = fa_cuda.core_row_stride(hd), fa_cuda.core_p_stride(plan.bn)
        floats = plan.bm * rs + plan.stages * 2 * plan.bn * rs + plan.bm * ps
        assert plan.smem_bytes == 4 * floats <= fa_cuda.SMEM_LIMIT
        assert plan.stages >= 2 and plan.bn in (32, 64)
        assert ssd_cuda.blocks_per_sm(plan.threads, plan.smem_bytes) >= 2

    @pytest.mark.parametrize("case", PLAN_FLASH)
    def test_core_vector_loads(self, case):
        """cp.async takes fp32 rows in 16-byte pieces only; bf16 and shifted
        rows move element by element."""
        dtype, offset = case[6], case[8]
        plan = fa_cuda.flash_plan(*meta_attention(*case))
        assert plan.vector_loads == (plan.route == "cuda_cores" and dtype == "float32" and not offset)
        if dtype == "float32":
            shifted = fa_cuda.flash_plan(*meta_attention(*case[:8], 1))
            assert shifted.route == "cuda_cores" and not shifted.vector_loads


class TestRMSNormPlan:
    @pytest.mark.parametrize("shape,dtype", PLAN_RMS)
    def test_route(self, shape, dtype):
        x = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
        plan = rms_cuda.rmsnorm_plan(x, torch.empty(shape[-1], device="meta"), torch.empty_like(x))
        d = shape[-1]
        if dtype == "bfloat16" and d % 8 == 0 and np.prod(shape[:-1]) >= rms_cuda.N_SM:
            assert plan.route == "registers"
            vpl = plan.vectors_per_lane
            assert vpl in rms_cuda.VECTORS_PER_LANE and 256 * vpl >= d
            assert all(256 * v < d for v in rms_cuda.VECTORS_PER_LANE if v < vpl)
        else:
            assert plan == rms_cuda.RMSNormPlan("block")

    @pytest.mark.parametrize("d", [384, 1024, 2304, 2560, 3072, 4096, 6144])
    def test_every_config_width_is_held_in_registers(self, d):
        x = torch.empty(1024, d, dtype=torch.bfloat16, device="meta")
        plan = rms_cuda.rmsnorm_plan(x, torch.empty(d, device="meta"), torch.empty_like(x))
        assert plan.route == "registers" and plan.vectors_per_lane == -(-d // 256)

    @pytest.mark.parametrize("what", ["x offset", "width past the largest count", "fp32",
                                      "fewer rows than SMs", "bf16 scale"])
    def test_other_rows_take_the_block_route(self, what):
        d = 6400 if what == "width past the largest count" else 2560
        dt = torch.float32 if what == "fp32" else torch.bfloat16
        offset = 1 if what == "x offset" else 0
        rows = 8 if what == "fewer rows than SMs" else 256
        scale_dt = torch.bfloat16 if what == "bf16 scale" else torch.float32
        x = torch.empty(rows * d + offset, dtype=dt, device="meta")[offset:].view(rows, d)
        plan = rms_cuda.rmsnorm_plan(x, torch.empty(d, dtype=scale_dt, device="meta"),
                                     torch.empty(rows, d, dtype=dt, device="meta"))
        assert plan.route == "block"


# Every SSD case of chip_smoke.py's kernels phase, and zamba_parity's forward:
# (b, H, s, P, N, chunk, dtype, model layout, y dtype, what G must satisfy)
PLAN_SSD = [
    (1, 80, 32768, 64, 64, 128, "bfloat16", True, "float32", "many"),   # zamba2's 32k forward
    (1, 80, 128, 64, 64, 128, "bfloat16", True, "float32", "one"),      # s == chunk
    (2, 80, 1024, 64, 64, 128, "bfloat16", True, "float32", "any"),
    (1, 80, 1024, 64, 64, 128, "bfloat16", True, "float32", "ragged"),
    (4, 80, 512, 64, 64, 128, "bfloat16", False, "bfloat16", "one"),    # b * H fills the card
    (1, 80, 384, 64, 64, 128, "bfloat16", True, "float32", "many"),     # zamba_parity, padded
    (1, 80, 384, 64, 64, 128, "float32", True, "float32", "one"),
    (1, 8, 384, 64, 64, 128, "float32", True, "float32", "one"),
    (2, 2, 64, 16, 8, 16, "float32", False, "float32", "one"),          # the reference's shapes
    (1, 4, 128, 32, 16, 32, "float32", False, "float32", "one"),
    (2, 1, 32, 8, 8, 32, "float32", False, "float32", "one"),
    (2, 2, 64, 16, 8, 16, "bfloat16", False, "bfloat16", "one"),
    (1, 4, 128, 32, 16, 32, "bfloat16", False, "bfloat16", "one"),
    (2, 1, 32, 8, 8, 32, "bfloat16", False, "bfloat16", "one"),
]
SEGMENTS = {"one": lambda g, n: g == 1, "many": lambda g, n: g > 1,
            "ragged": lambda g, n: n % g != 0, "any": lambda g, n: 1 <= g <= n}


def meta_ssd(b, H, s, P, N, chunk, dtype, model_layout, y_dtype, offset=0):
    """``ssd_plan``'s arguments as meta tensors with the strides the model (or
    a contiguous caller) gives them; ``offset`` shifts x's storage by that
    many elements."""
    dt_ = getattr(torch, dtype)
    if model_layout:
        x = torch.empty(b * s * H * P + offset, dtype=dt_, device="meta")[offset:]
        x = x.view(b, s, H, P).transpose(1, 2)
        B, C = (torch.empty(b, s, N, dtype=dt_, device="meta")[:, None].expand(b, H, s, N)
                for _ in range(2))
    else:
        x = torch.empty(b * H * s * P + offset, dtype=dt_, device="meta")[offset:].view(b, H, s, P)
        B, C = (torch.empty(b, H, s, N, dtype=dt_, device="meta") for _ in range(2))
    y = ssd_cuda._output(x, getattr(torch, y_dtype))
    return x, B, C, min(chunk, s), y


class TestSSDPlan:
    """``ssd_plan`` is the launch the C entry point validates and runs; here
    it is checked on the CPU at every shape the chip smoke gives the kernel."""

    @pytest.mark.parametrize("case", PLAN_SSD)
    def test_route(self, case):
        b, H, s, P, N, chunk, dtype = case[:7]
        plan = ssd_cuda.ssd_plan(*meta_ssd(*case[:9]))
        tc = dtype == "bfloat16" and (min(chunk, s), P, N) == (128, 64, 64)
        assert plan.route == ("tensor_cores" if tc else "cuda_cores")

    @pytest.mark.parametrize("case", PLAN_SSD)
    def test_segments_and_grid(self, case):
        b, H, s, P, N, chunk, dtype, model_layout = case[:8]
        plan = ssd_cuda.ssd_plan(*meta_ssd(*case[:9]))
        n_chunks = s // min(chunk, s)
        if plan.route == "cuda_cores":
            assert (plan.segments, plan.heads_per_block, plan.grid, plan.threads) == (1, 1, (H, b, 1), 256)
            return
        hb = 2 if model_layout and H % 2 == 0 else 1   # B/C shared by the heads
        assert plan.heads_per_block == hb and plan.threads == 128 * hb
        assert SEGMENTS[case[9]](plan.segments, n_chunks)
        assert plan.grid == (plan.segments, H // hb, b)
        assert (plan.state_smem_bytes > 0) == (plan.segments > 1)

    @pytest.mark.parametrize("case", PLAN_SSD)
    def test_shared_memory_fits_a_block(self, case):
        plan = ssd_cuda.ssd_plan(*meta_ssd(*case[:9]))
        assert 0 < plan.smem_bytes <= fa_cuda.SMEM_LIMIT
        assert 0 <= plan.state_smem_bytes <= fa_cuda.SMEM_LIMIT

    def test_the_32k_forward_fills_the_card_twice(self):
        """At zamba2's 32k forward at least two blocks a SM run in pass B."""
        plan = ssd_cuda.ssd_plan(*meta_ssd(*PLAN_SSD[0][:9]))
        assert np.prod(plan.grid) >= 2 * ssd_cuda.N_SM

    @pytest.mark.parametrize("what", ["x offset", "chunk 64", "P 32", "N 32", "fp32 x"])
    def test_other_inputs_take_the_cuda_cores(self, what):
        args = dict(b=1, H=8, s=512, P=64, N=64, chunk=128, dtype="bfloat16", model_layout=True,
                    y_dtype="float32")
        args.update({"chunk 64": {"chunk": 64}, "P 32": {"P": 32}, "N 32": {"N": 32},
                     "fp32 x": {"dtype": "float32"}}.get(what, {}))
        plan = ssd_cuda.ssd_plan(*meta_ssd(**args, offset=1 if what == "x offset" else 0))
        assert plan.route == "cuda_cores"

    def test_segments_rule(self):
        slots = ssd_cuda.N_SM
        assert ssd_cuda.segments_for(slots, 256, slots, 2 * slots) == 1     # fills the card
        assert ssd_cuda.segments_for(40, 1, slots, 2 * slots) == 1          # one chunk
        for n in (2, 3, 8, 256):
            assert 1 <= ssd_cuda.segments_for(40, n, slots, 2 * slots) <= n

    def test_plan_array_layout(self):
        plan = ssd_cuda.ssd_plan(*meta_ssd(*PLAN_SSD[0][:9]))
        assert list(plan.as_array()) == [1, plan.heads_per_block, plan.segments, plan.threads,
                                         *plan.grid, plan.smem_bytes, plan.state_smem_bytes]
        assert len(plan.as_array()) == ssd_cuda.PLAN_LEN


# ------------------------------------------------------------- backwards
def grads_via_autograd(fn, inputs, dout):
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    return torch.autograd.grad(fn(*leaves), leaves, dout)


FA_BWD_GRID = [              # b, hq, hkv, sq, skv, hd, causal
    (2, 4, 2, 64, 64, 32, True),      # GQA
    (1, 8, 1, 48, 48, 16, True),      # MQA
    (1, 4, 2, 24, 80, 16, True),      # causal offset: sq < skv
    (2, 4, 4, 37, 37, 64, True),      # ragged
    (1, 4, 2, 40, 24, 32, False),     # non-causal, sq > skv
]


class TestFlashAttentionBwdRef:
    """``ref.flash_attention_bwd_ref``, the plain version of the backward
    kernel, against autograd through the plain forward and against
    ``jax.grad`` of the reference's ``flash_attention_ref``."""

    @staticmethod
    def inputs(rng, dtype, b, hq, hkv, sq, skv, hd):
        return [make(rng, s, dtype) for s in
                [(b, hq, sq, hd), (b, hkv, skv, hd), (b, hkv, skv, hd), (b, hq, sq, hd)]]

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,hd,causal", FA_BWD_GRID)
    def test_matches_autograd_through_the_plain_forward(self, dtype, b, hq, hkv, sq, skv, hd,
                                                        causal):
        q, k, v, do = (t for _, t in self.inputs(np.random.default_rng(0), dtype, b, hq, hkv, sq,
                                                  skv, hd))
        want = grads_via_autograd(lambda *a: ref.flash_attention_ref(*a, causal), (q, k, v), do)
        out, lse = ref.flash_attention_lse_ref(q, k, v, causal)
        got = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
        rtol, atol = TOL[dtype]
        for g, w, x in zip(got, want, (q, k, v)):
            assert g.dtype == x.dtype and g.shape == x.shape
            np.testing.assert_allclose(to_np(g), to_np(w), rtol=rtol, atol=atol)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("b,hq,hkv,sq,skv,hd,causal", FA_BWD_GRID)
    def test_matches_jax_grad_of_the_reference(self, dtype, b, hq, hkv, sq, skv, hd, causal):
        (qj, qt), (kj, kt), (vj, vt), (doj, dot) = self.inputs(
            np.random.default_rng(1), dtype, b, hq, hkv, sq, skv, hd)
        _, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(q, k, v, causal), qj, kj, vj)
        want = vjp(doj)
        out, lse = ref.flash_attention_lse_ref(qt, kt, vt, causal)
        got = ref.flash_attention_bwd_ref(qt, kt, vt, out, lse, dot, causal)
        rtol, atol = TOL[dtype]
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), to_np(w), rtol=rtol, atol=atol)

    @pytest.mark.parametrize("b,hq,hkv,sq,skv,hd,causal", FA_BWD_GRID)
    def test_lse_is_the_log_sum_exp_of_the_visible_scores(self, b, hq, hkv, sq, skv, hd, causal):
        rng = np.random.default_rng(2)
        q, k, v = (rng.standard_normal(s) for s in [(b, hq, sq, hd), (b, hkv, skv, hd),
                                                    (b, hkv, skv, hd)])
        kq = np.repeat(k, hq // hkv, axis=1)
        scores = np.einsum("bhqd,bhkd->bhqk", q, kq) / np.sqrt(hd)
        if causal:
            scores = np.where(np.tril(np.ones((sq, skv), bool), skv - sq), scores, -np.inf)
        top = scores.max(-1, keepdims=True)
        want = (top + np.log(np.exp(scores - top).sum(-1, keepdims=True)))[..., 0]
        out, lse = ref.flash_attention_lse_ref(*(torch.tensor(t, dtype=torch.float32)
                                                 for t in (q, k, v)), causal)
        assert lse.shape == (b, hq, sq) and lse.dtype == torch.float32
        np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
        plain = ref.flash_attention_ref(*(torch.tensor(t, dtype=torch.float32) for t in (q, k, v)),
                                        causal)
        torch.testing.assert_close(out, plain, rtol=0, atol=0)

    @pytest.mark.parametrize("causal", [False, True])
    def test_bf16_d_reads_the_unrounded_out(self, causal):
        """bf16 with keys and values that share a large common part
        (near-uniform attention over many keys, Whisper's case at random
        init): D from the rounded out errs by 2^-9 |dO| |O|, which dS = P (dP
        - D) takes whole.  ``ops.flash_attention``'s backward reads out +
        out_res (what rounding dropped) and lands within 2 % of the fp32
        gradient where D from out alone misses dq by more than its size."""
        g = torch.Generator().manual_seed(7)
        common = 4.0 * torch.randn(64, generator=g)
        q = (0.3 * torch.randn(1, 2, 300, 64, generator=g)).bfloat16()
        k, v = ((common + 0.3 * torch.randn(1, 2, 300, 64, generator=g)).bfloat16()
                for _ in range(2))
        do = torch.randn(1, 2, 300, 64, generator=g).bfloat16()
        want = grads_via_autograd(lambda *a: ref.flash_attention_ref(*a, causal),
                                  tuple(t.float() for t in (q, k, v)), do.float())
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ops.flash_attention(*leaves, causal=causal).backward(do)
        out, lse = ref.flash_attention_lse_ref(q, k, v, causal)
        rounded = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal)

        def rel(a, w):
            return ((a.float() - w).norm() / w.norm()).item()

        assert rel(leaves[0].grad, want[0]) < 0.02 < 1.0 < rel(rounded[0], want[0])
        for got, w in zip((t.grad for t in leaves[1:]), want[1:]):
            assert rel(got, w) < 0.02

    def test_strided_dout_gives_the_same_gradients(self):
        """Autograd hands dout back as a transposed view of the model's
        (b, s, h, hd) layout."""
        g = torch.Generator().manual_seed(6)
        q, k, v = (torch.randn(1, 2, 24, 16, generator=g) for _ in range(3))
        do = torch.randn(1, 24, 2, 16, generator=g)
        out, lse = ref.flash_attention_lse_ref(q, k, v)
        a = ref.flash_attention_bwd_ref(q, k, v, out, lse, do.transpose(1, 2))
        b = ref.flash_attention_bwd_ref(q, k, v, out, lse, do.transpose(1, 2).contiguous())
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


class TestRMSNormBwdRef:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", RMS_SHAPES)
    def test_matches_autograd_through_the_plain_forward(self, dtype, shape):
        rng = np.random.default_rng(0)
        (_, x), (_, dy) = make(rng, shape, dtype), make(rng, shape, dtype)
        scale = torch.from_numpy((rng.standard_normal(shape[-1]) + 1.0).astype(np.float32))
        want = grads_via_autograd(lambda a, s: ref.rmsnorm_ref(a, s, 1e-5), (x, scale), dy)
        dx, dscale = ref.rmsnorm_bwd_ref(x, scale, dy, 1e-5)
        assert dx.dtype == x.dtype and dscale.dtype == torch.float32
        rtol, atol = TOL[dtype]
        np.testing.assert_allclose(to_np(dx), to_np(want[0]), rtol=rtol, atol=atol)
        # dscale sums over rows: bf16 rounds each row's product once, summed in fp32
        np.testing.assert_allclose(to_np(dscale), to_np(want[1]), rtol=rtol, atol=atol * 4)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", RMS_SHAPES)
    def test_matches_jax_grad_of_the_reference(self, dtype, shape):
        rng = np.random.default_rng(1)
        (xj, xt), (dyj, dyt) = make(rng, shape, dtype), make(rng, shape, dtype)
        s = (rng.standard_normal(shape[-1]) + 1.0).astype(np.float32)
        _, vjp = jax.vjp(lambda x, sc: jref.rmsnorm_ref(x, sc, 1e-6), xj, jnp.asarray(s))
        want_dx, want_ds = vjp(dyj)
        dx, dscale = ref.rmsnorm_bwd_ref(xt, torch.from_numpy(s), dyt, 1e-6)
        rtol, atol = TOL[dtype]
        np.testing.assert_allclose(to_np(dx), to_np(want_dx), rtol=rtol, atol=atol)
        np.testing.assert_allclose(to_np(dscale), to_np(want_ds), rtol=rtol, atol=atol * 4)


# Every flash-attention backward case of chip_smoke.py's kernels phase:
# (b, hq, hkv, sq, skv, hd, dtype, model layout, offset in elements)
PLAN_FLASH_BWD = [
    (4, 36, 36, 1024, 1024, 64, "bfloat16", True, 0),    # minicpm-2b's training step
    (4, 36, 36, 1024, 1024, 64, "float32", True, 0),     # and in the launcher's fp32
    (1, 32, 2, 1024, 1024, 128, "bfloat16", True, 0),    # GQA, hd 128
    (2, 8, 8, 300, 300, 80, "bfloat16", True, 0),        # hd 80, ragged
    (1, 4, 2, 75, 203, 64, "float32", False, 0),         # causal offset
    (1, 4, 2, 100, 70, 32, "float32", False, 0),         # non-causal, sq > skv
    (4, 36, 36, 1024, 1024, 64, "bfloat16", True, 1),    # unaligned bf16
    (2, 4, 4, 16, 16, 16, "float32", True, 0),           # the launcher's reduced config
    (4, 32, 32, 1600, 1600, 96, "bfloat16", True, 0),    # phi-3-vision's step
    (4, 32, 32, 1600, 1600, 96, "float32", True, 0),     # and in the launcher's fp32
    (1, 4, 4, 150, 150, 96, "bfloat16", False, 1),       # hd 96 unaligned, ragged
    (1, 64, 4, 1024, 1024, 128, "bfloat16", True, 0),    # qwen3-moe's training step, GQA 16:1
    (4, 16, 1, 1024, 1024, 128, "bfloat16", True, 0),    # glm4-9b's step, a rank's shards on (2, 2)
    (4, 24, 4, 1024, 1024, 128, "bfloat16", True, 0),    # dbrx-132b's step, a rank's shards on (2, 2)
    (4, 6, 6, 1500, 1500, 64, "bfloat16", True, 0),      # whisper-tiny's encoder, non-causal
    (4, 6, 6, 1500, 1500, 64, "float32", True, 0),       # and in the launcher's fp32
    (4, 6, 6, 448, 1500, 64, "bfloat16", True, 0),       # its cross-attention, 448 over 1500
    (4, 6, 6, 448, 1500, 64, "float32", True, 0),
    (4, 6, 6, 448, 448, 64, "bfloat16", True, 0),        # its decoder's self-attention
    (4, 6, 6, 448, 448, 64, "float32", True, 0),
]


def meta_bwd(case):
    """``flash_bwd_plan``'s arguments as meta tensors: q, k, v, out and dout
    with chip_smoke.py's strides and offsets, and the wrapper's gradients."""
    q, k, v, out = meta_attention(*case)
    dout = meta_attention(*case)[0]
    return q, k, v, out, dout, *(fa_cuda._dense_like(t) for t in (q, k, v))
# Every RMSNorm backward case of chip_smoke.py: (shape, dtype)
PLAN_RMS_BWD = [
    ((4, 1024, 2304), "bfloat16"),
    ((4, 1024, 2304), "float32"),
    ((8, 64, 64), "bfloat16"),
    ((3, 37, 1000), "float32"),
    ((5, 4099), "bfloat16"),
    ((1, 4096, 2560), "bfloat16"),  # zamba2-2.7b's width: 10 vectors a lane
    ((256, 6144), "bfloat16"),      # 24 vectors a lane: the partials in shared memory
    ((2, 16, 64), "float32"),       # the launcher's reduced config
    ((4, 256, 1024), "bfloat16"),   # xlstm-350m's training step
    ((4, 1500, 384), "bfloat16"),   # whisper-tiny's encoder
    ((4, 448, 384), "bfloat16"),    # and its decoder
    ((4, 1024, 6144), "bfloat16"),  # dbrx-132b's step, a rank's rows on (2, 2)
]


class TestFlashBwdPlan:
    """``flash_bwd_plan`` on the CPU at every shape the chip smoke gives the
    backward: aligned bf16 on ``wgmma`` (TMA, a GQA split that fills the
    card), everything else on the CUDA cores."""

    @pytest.mark.parametrize("case", PLAN_FLASH_BWD)
    def test_route(self, case):
        plan = fa_cuda.flash_bwd_plan(*meta_bwd(case))
        dtype, offset = case[6], case[8]
        assert plan.route == ("wgmma" if dtype == "bfloat16" and offset == 0 else "cuda_cores")

    @pytest.mark.parametrize("case", PLAN_FLASH_BWD)
    def test_grids_cover_every_tile(self, case):
        """Both grids cover every row tile once, and the dK/dV grid's splits
        cover every query head of each kv head's group once."""
        b, hq, hkv, sq, skv, hd = case[:6]
        plan = fa_cuda.flash_bwd_plan(*meta_bwd(case))
        assert plan.grid_dq == (-(-sq // plan.rows), hq, b)
        assert plan.grid_dkv == (-(-skv // plan.rows), hkv * plan.splits, b)
        group = hq // hkv
        share = group // plan.splits
        heads = sorted(hk * group + split * share + g
                       for y in range(plan.grid_dkv[1]) for hk, split in [divmod(y, plan.splits)]
                       for g in range(share))
        assert heads == list(range(hq))
        stats_rows = b * hq * plan.sq_pad
        if plan.route == "cuda_cores":
            # 16 x 8 threads of 4-row micro-tiles own 64 rows and walk 32-row
            # tiles through 3 stages (2 beyond hd 64); the dQ kernel computes
            # D (no D pass) and stores it with lse in rows padded to its 64
            assert (plan.rows, plan.threads) == (64, 128)
            assert plan.stages == (3 if hd <= 64 else 2) and plan.cols == plan.cols_dq == 32
            assert plan.dot_blocks == 0
            assert plan.sq_pad == plan.grid_dq[0] * plan.rows and 0 <= plan.sq_pad - sq < plan.rows
            assert plan.stats_floats == 2 * stats_rows
        else:
            # two consumer warpgroups of 64 rows and a producer; the dQ kernel
            # computes D and stores it with lse in rows padded to the block, so
            # every walked tile's pair is in bounds
            assert (plan.rows, plan.threads, plan.stages) == (128, 384, fa_cuda.BWD_STAGES)
            assert plan.dot_blocks == 0
            assert plan.cols == (32 if hd >= 128 else 64) and plan.cols_dq == 64
            assert plan.sq_pad % plan.rows == 0 and 0 <= plan.sq_pad - sq < plan.rows
            assert plan.stats_floats == 2 * stats_rows
        assert plan.cols % 16 == 0 and plan.cols_dq % 16 == 0 and plan.rows % plan.cols == 0

    @pytest.mark.parametrize("case", PLAN_FLASH_BWD)
    def test_gqa_split_fills_the_card(self, case):
        """``splits`` divides the group and is 1 at MHA (no workspace, no
        second pass); a split GQA group gives every SM a dK/dV block and
        its fp32 partial dK/dV a workspace of the stated size."""
        b, hq, hkv, sq, skv, hd = case[:6]
        plan = fa_cuda.flash_bwd_plan(*meta_bwd(case))
        group = hq // hkv
        assert group % plan.splits == 0
        blocks = int(np.prod(plan.grid_dkv))
        if group == 1:
            assert plan.splits == 1 and plan.workspace_bytes == 0
        else:
            base = blocks // plan.splits
            assert blocks >= fa_cuda.SMS or plan.splits == group
            # the fewest splits that do it
            assert all(base * d < fa_cuda.SMS for d in range(1, plan.splits) if group % d == 0)
            assert plan.workspace_bytes == (2 * plan.splits * b * hkv * skv * hd * 4
                                            if plan.splits > 1 else 0)
        if (hq, hkv, hd, plan.route) == (32, 2, 128, "wgmma"):   # glm4-9b's GQA 16:1
            assert blocks >= fa_cuda.SMS and plan.splits == 16
            assert plan.workspace_bytes == 2 * 16 * 2 * 1024 * 128 * 4

    @pytest.mark.parametrize("case", PLAN_FLASH_BWD)
    def test_shared_memory_fits_two_blocks(self, case):
        """The CUDA-core kernels fit two blocks an SM with their stages; a
        wgmma block (one an SM, 384 threads) fits the opt-in limit beside its
        mbarriers."""
        plan = fa_cuda.flash_bwd_plan(*meta_bwd(case))
        for smem in (plan.smem_bytes, plan.smem_dq_bytes):
            limit = fa_cuda.SMEM_LIMIT // 2 if plan.route == "cuda_cores" else fa_cuda.SMEM_LIMIT - 64
            assert 0 < smem <= limit and smem % 16 == 0
        if plan.route == "cuda_cores":
            hd = case[5]
            rs, tail = fa_cuda.core_row_stride(hd), plan.rows * fa_cuda.core_p_stride(plan.cols)
            own, tile = 2 * plan.rows * rs, plan.cols * rs
            assert plan.smem_bytes == 4 * (own + plan.stages * (2 * tile + 2 * plan.cols) + tail)
            assert plan.smem_dq_bytes == 4 * (own + plan.stages * 2 * tile + tail)
            assert ssd_cuda.blocks_per_sm(plan.threads, max(plan.smem_bytes, plan.smem_dq_bytes)) >= 2

    @pytest.mark.parametrize("hd", fa_cuda.HEAD_DIMS)
    def test_every_head_dim_tiles_the_fragments(self, hd):
        """CUDA cores: 16 x 16 threads take hd / 16 output columns each and
        read fp32 rows of hd + 4 as 16-byte vectors.  wgmma: k-steps of 16
        over each head-dim slab of at most 64 columns and over the walked
        tiles, and every slab of the shared-memory layout starting on its
        swizzle's period (8 rows of its width), in the owned tensors, the
        two warpgroups' halves and every stage."""
        for dtype in ("float32", "bfloat16"):
            plan = fa_cuda.flash_bwd_plan(*meta_bwd((1, 2, 2, 8, 8, hd, dtype, False, 0)))
            assert hd % 16 == 0 and plan.cols % 16 == 0
            if plan.route == "cuda_cores":
                # 8 threads a row of the thread grid take hd / 8 columns each,
                # in 4- or 2-float vectors; rows stay 16-byte aligned
                assert hd % (8 * 2) == 0 and fa_cuda.core_row_stride(hd) % 4 == 0
                assert fa_cuda.core_p_stride(plan.cols) % 4 == 0 and plan.cols % 4 == 0
                continue
            slabs = fa_cuda.head_dim_slabs(hd)
            assert all(w <= 64 and w % 16 == 0 for _, w, _ in slabs)
            assert [m.slabs for m in plan.maps] == [slabs] * 8
            for cols, stats in ((plan.cols, True), (plan.cols_dq, False)):
                own, tile = plan.rows * hd * 2, cols * hd * 2   # one owned / walked tensor
                loaded = 2 * tile + (8 * cols if stats else 0)
                stage = -(-loaded // 1024) * 1024
                assert fa_cuda.bwd_wgmma_smem(hd, cols, stats) == 1024 + 4 * own + 3 * stage
                for first, rows in ((0, plan.rows), (2 * own, plan.rows), (4 * own, cols),
                                    (4 * own + stage, cols)):
                    for tensor in range(2):
                        at = first + tensor * (own if rows == plan.rows else tile)
                        for col, w, swz in slabs:
                            start = at + rows * col * 2   # slab 1 after slab 0's rows
                            assert start % (8 * swz) == 0
                            if rows == plan.rows:         # warpgroup 1's 64 rows
                                assert (start + 64 * w * 2) % (8 * swz) == 0
                if stats:   # lse and D after the two walked tensors, 16-byte aligned
                    assert 2 * tile % 16 == 0 and (2 * tile + 4 * cols) % 16 == 0

    def test_plan_array_layout(self):
        """MHA and GQA on wgmma (eight tensor maps), and the CUDA cores (none)."""
        for case in PLAN_FLASH_BWD[:3]:
            plan = fa_cuda.flash_bwd_plan(*meta_bwd(case))
            values = [fa_cuda.BWD_ROUTES.index(plan.route), plan.rows, plan.cols, plan.cols_dq,
                      plan.stages, plan.threads, *plan.grid_dq, *plan.grid_dkv, plan.smem_bytes,
                      plan.smem_dq_bytes, plan.dot_blocks, plan.splits, plan.sq_pad,
                      plan.workspace_bytes]
            for m in plan.maps:
                values += m.values()
            if plan.route == "cuda_cores":   # vector_loads in the first map's place
                values.append(int(plan.vector_loads))
            assert len(plan.maps) == (8 if plan.route == "wgmma" else 0)
            assert list(plan.as_array()) == values + [0] * (fa_cuda.BWD_PLAN_LEN - len(values))

    @pytest.mark.parametrize("case", [c for c in PLAN_FLASH_BWD if c[6] == "float32" or c[8]])
    def test_core_walks_cover_every_visible_pair_once(self, case):
        """CUDA cores, as the C side walks: each dK/dV block (64 keys, its
        split's query heads) walks the 32-query tiles from the first that
        sees its keys; each dQ block (64 queries) the 32-key tiles up to its
        causal limit.  Every visible (query, key) pair of every head lies in
        exactly one walked tile of each kernel, every walked lse/D tile lies
        inside the padded workspace the dQ kernel writes."""
        b, hq, hkv, sq, skv, hd = case[:6]
        causal = sq <= skv
        plan = fa_cuda.flash_bwd_plan(*meta_bwd(case))
        rows, cols, off = plan.rows, plan.cols, skv - sq
        group, share = hq // hkv, hq // hkv // plan.splits
        q_idx, k_idx = np.arange(sq)[:, None], np.arange(skv)[None, :]
        visible = (k_idx <= q_idx + off) if causal else np.ones((sq, skv), bool)
        dkv = np.zeros((hq, sq, skv), np.int8)
        for kt in range(plan.grid_dkv[0]):
            k0 = kt * rows
            first = max(0, k0 - off) // cols if causal else 0
            for y in range(plan.grid_dkv[1]):
                hk, split = divmod(y, plan.splits)
                for h in range(hk * group + split * share, hk * group + (split + 1) * share):
                    for u in range(first, -(-sq // cols)):
                        assert (u + 1) * cols <= plan.sq_pad
                        dkv[h, u * cols:(u + 1) * cols, k0:k0 + rows] += 1
        dq = np.zeros((sq, skv), np.int8)
        for qt in range(plan.grid_dq[0]):
            q0 = qt * rows
            kv_end = min(skv, min(q0 + rows, sq) + off) if causal else skv
            for k0 in range(0, kv_end, cols):
                dq[q0:q0 + rows, k0:k0 + cols] += 1
        assert (dkv[:, visible] == 1).all() and dkv.max() == 1
        assert (dq[visible] == 1).all() and dq.max() == 1

    @pytest.mark.parametrize("hd", fa_cuda.HEAD_DIMS)
    @pytest.mark.parametrize("cols", [32, 64])
    def test_core_strides_are_free_of_bank_conflicts(self, hd, cols):
        """Every shared-memory access of a warp in the CUDA-core products
        (lane = 8 (ty % 4) + tx; rows ty + 16 i, columns tx + 8 j or a
        thread's hd / 8 output columns) touches each of the 32 banks through
        at most one distinct address: the 16-byte reads of two operand tiles
        (rows of hd + 4 floats), the P tile's scalar stores and 16-byte reads
        (rows of cols + 8), and the walked tile's vector reads along a row."""
        rs, ps = fa_cuda.core_row_stride(hd), fa_cuda.core_p_stride(cols)
        n = hd // 8
        vw = 4 if n % 4 == 0 else 2

        def conflict_free(floats_at, width):
            addrs = sorted(set(floats_at))
            banks = [(a + e) % 32 for a in addrs for e in range(width)]
            return all(a % width == 0 for a in addrs) and len(banks) == len(set(banks))

        lanes = [(w * 4 + lane // 8, lane % 8) for w in range(4) for lane in range(32)]
        for w in range(4):
            warp = lanes[32 * w: 32 * (w + 1)]
            for d in range(0, hd, 4):
                for i in range(4):   # the owned operand's rows, 16-byte reads along hd
                    assert conflict_free([(ty + 16 * i) * rs + d for ty, _ in warp], 4)
                for j in range(cols // 8):   # the walked operand's rows
                    assert conflict_free([(tx + 8 * j) * rs + d for _, tx in warp], 4)
            for i in range(4):
                for j in range(cols // 8):   # P stores
                    assert conflict_free([(ty + 16 * i) * ps + tx + 8 * j for ty, tx in warp], 1)
                for k in range(0, cols, 4):   # P reads along a row
                    assert conflict_free([(ty + 16 * i) * ps + k for ty, _ in warp], 4)
            for k in range(cols):   # the walked tile's vectors along its row k
                for g in range(n // vw):
                    assert conflict_free([k * rs + vw * tx + 8 * vw * g for _, tx in warp], vw)
        # each thread's output columns cover hd once
        assert sorted(vw * tx + 8 * vw * (c // vw) + c % vw
                      for tx in range(8) for c in range(n)) == list(range(hd))

    @pytest.mark.parametrize("case", PLAN_FLASH_BWD)
    def test_core_vector_loads(self, case):
        """cp.async takes fp32 rows in 16-byte pieces only; bf16 (the
        unaligned rows) moves element by element."""
        plan = fa_cuda.flash_bwd_plan(*meta_bwd(case))
        assert plan.vector_loads == (plan.route == "cuda_cores" and case[6] == "float32"
                                     and not case[8])

    @pytest.mark.parametrize("case", [c for c in PLAN_FLASH_BWD if c[6] == "bfloat16" and not c[8]])
    def test_tensor_maps(self, case):
        """dK/dV owns k, v (boxes of 128 keys) and walks q, dout (tiles of
        ``cols`` queries); dQ owns q, dout and walks k, v (``cols_dq`` keys):
        each map has its tensor's dims and 16-byte strides."""
        b, hq, hkv, sq, skv, hd = case[:6]
        q, k, v, out, dout, *_ = meta_bwd(case)
        plan = fa_cuda.flash_bwd_plan(q, k, v, out, dout, *(fa_cuda._dense_like(t) for t in (q, k, v)))
        tensors = (k, v, q, dout, q, dout, k, v)
        boxes = (128, 128, plan.cols, plan.cols, 128, 128, plan.cols_dq, plan.cols_dq)
        for m, t, box in zip(plan.maps, tensors, boxes, strict=True):
            assert m == fa_cuda._tensor_map(t, box)
            assert m.dims == (hd, t.shape[2], t.shape[1], b)
            assert all(st % 16 == 0 for st in m.strides)


class TestRMSNormBwdPlan:
    @staticmethod
    def plan(shape, dtype):
        x = torch.empty(shape, dtype=getattr(torch, dtype), device="meta")
        scale = torch.empty(shape[-1], dtype=torch.float32, device="meta")
        return (rms_cuda.rmsnorm_bwd_plan(x, scale, torch.empty_like(x)),
                rms_cuda.rmsnorm_plan(x, scale, torch.empty_like(x)))

    @pytest.mark.parametrize("shape,dtype", PLAN_RMS_BWD)
    def test_route_is_the_forwards(self, shape, dtype):
        bwd, fwd = self.plan(shape, dtype)
        assert bwd.route == fwd.route and bwd.vectors_per_lane == fwd.vectors_per_lane

    @pytest.mark.parametrize("shape,dtype", PLAN_RMS_BWD)
    def test_blocks_and_threads(self, shape, dtype):
        bwd, _ = self.plan(shape, dtype)
        rows, d = int(np.prod(shape[:-1])), shape[-1]
        if bwd.route == "registers":
            # one block an SM of up to BWD_WARPS warps, as few as fill the card
            warps = min(rms_cuda.bwd_max_warps(bwd.vectors_per_lane), -(-rows // rms_cuda.N_SM))
            assert bwd.threads == 32 * warps
            assert 1 <= bwd.blocks == min(rms_cuda.N_SM, -(-rows // warps))
            assert bwd.units == 0 and bwd.vector_loads
        else:
            assert 1 <= bwd.blocks == min(rows, rms_cuda.BWD_BLOCKS)
            # the forward block kernel's rule (csrc/rmsnorm.cu, launch)
            vec = 16 // getattr(torch, dtype).itemsize
            per_thread = vec if d % vec == 0 else 1
            assert bwd.threads == min(512, -(-(-(-d // per_thread)) // 32) * 32)
            assert bwd.threads % 32 == 0
            assert bwd.vector_loads == (per_thread == vec)
            # the fewest parked units that cover the row, of those built
            n_units = -(-d // per_thread)
            assert bwd.units in rms_cuda.BWD_UNITS[bwd.vector_loads]
            assert bwd.units * bwd.threads >= n_units
            assert all(u * bwd.threads < n_units for u in rms_cuda.BWD_UNITS[bwd.vector_loads]
                       if u < bwd.units)

    @pytest.mark.parametrize("shape,dtype", PLAN_RMS_BWD)
    def test_the_walk_takes_every_row_once(self, shape, dtype):
        bwd, _ = self.plan(shape, dtype)
        rows = int(np.prod(shape[:-1]))
        walked = [r for b in range(bwd.blocks) for r in bwd.rows_of(b, rows)]
        assert sorted(walked) == list(range(rows))
        assert all(bwd.rows_of(b, rows) for b in range(bwd.blocks))   # no block idles

    @pytest.mark.parametrize("shape,dtype", PLAN_RMS_BWD)
    def test_workspace_is_a_partial_row_a_block(self, shape, dtype):
        bwd, _ = self.plan(shape, dtype)
        assert bwd.workspace_shape(shape[-1]) == (bwd.blocks, shape[-1])

    @pytest.mark.parametrize("shape,dtype", PLAN_RMS_BWD)
    def test_shared_memory_fits(self, shape, dtype):
        """The rings (two slots of x's and dy's 16-byte pieces) and, past
        REGISTER_PARTIALS_VPL vectors a lane, the partials fit the opt-in
        limit with 1 KB to spare for the static arrays."""
        bwd, _ = self.plan(shape, dtype)
        assert 0 <= bwd.smem_bytes <= rms_cuda.SMEM_LIMIT - 1024
        ring = 2 * rms_cuda.BWD_RING
        if bwd.route == "registers":
            vpl = bwd.vectors_per_lane
            shared = 2 * vpl if bwd.partials == "shared" else 0
            assert bwd.smem_bytes == bwd.threads // 32 * (ring * vpl + shared) * 512
            # the widest block the plan may take fits too
            assert rms_cuda.bwd_max_warps(vpl) * (ring * vpl + shared) * 512 <= rms_cuda.SMEM_LIMIT - 1024
        else:
            assert bwd.smem_bytes == (ring * bwd.units * bwd.threads * 16 if bwd.vector_loads else 0)

    @pytest.mark.parametrize("shape,dtype", PLAN_RMS_BWD)
    def test_partials_in_registers_up_to_12_vectors(self, shape, dtype):
        bwd, _ = self.plan(shape, dtype)
        shared = bwd.route == "registers" and bwd.vectors_per_lane > rms_cuda.REGISTER_PARTIALS_VPL
        assert bwd.partials == ("shared" if shared else "registers")

    @pytest.mark.parametrize("vpl", [2, 4, 9, 10, 12, 16, 24])
    def test_every_vector_count_has_a_grid(self, vpl):
        d = 256 * vpl
        x = torch.empty(4096, d, dtype=torch.bfloat16, device="meta")
        bwd = rms_cuda.rmsnorm_bwd_plan(x, torch.empty(d, device="meta"), torch.empty_like(x))
        assert bwd.vectors_per_lane == vpl and bwd.blocks == rms_cuda.N_SM
        assert bwd.partials == ("registers" if vpl <= 12 else "shared")
        assert bwd.smem_bytes <= rms_cuda.SMEM_LIMIT


# --------------------------------------------------- autograd through ops
class TestAutograd:
    """``ops.rmsnorm`` and ``ops.flash_attention`` join autograd on every
    device; on the CPU their backward is the plain analytic one."""

    def test_every_parameter_of_a_reduced_model_gets_a_gradient(self):
        from repro_torch.configs import get_config
        from repro_torch.models import ModelOptions, build_model

        cfg = get_config("glm4-9b").reduced()
        model = build_model(cfg, ModelOptions("float32", "float32", remat=True), device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        leaves = jax.tree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tokens = torch.randint(0, cfg.vocab, (2, 12), generator=torch.Generator().manual_seed(1))
        ops.reset_launch_counts()
        loss, _ = model.loss(params, {"tokens": tokens, "labels": tokens.roll(-1, 1)})
        loss.backward()
        assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in leaves)
        assert sum(ops.launch_counts().values()) == 0   # the CPU runs the plain versions

    def test_ops_are_autograd_functions_with_the_plain_backward(self):
        g = torch.Generator().manual_seed(7)
        q, k, v = (torch.randn(1, 2, 8, 16, generator=g, requires_grad=True) for _ in range(3))
        x = torch.randn(4, 16, generator=g, requires_grad=True)
        scale = torch.ones(16, requires_grad=True)
        out, y = ops.flash_attention(q, k, v), ops.rmsnorm(x, scale)
        assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
        assert type(y.grad_fn).__name__ == "_RMSNormBackward"
        with mock.patch.object(ref, "flash_attention_bwd_ref", wraps=ref.flash_attention_bwd_ref) as fa, \
                mock.patch.object(ref, "rmsnorm_bwd_ref", wraps=ref.rmsnorm_bwd_ref) as rms:
            (out.sum() + y.sum()).backward()
        assert fa.call_count == 1 and rms.call_count == 1
        assert all(t.grad is not None for t in (q, k, v, x, scale))

    def test_without_grad_the_forward_runs_alone(self):
        q = torch.randn(1, 2, 8, 16, requires_grad=True)
        with torch.no_grad():
            assert ops.flash_attention(q, q, q).grad_fn is None
        assert ops.rmsnorm(torch.randn(2, 8), torch.ones(8)).grad_fn is None

    def test_ssd_scan_on_a_cuda_tensor_that_requires_grad_raises(self):
        """A CUDA tensor that requires grad goes through the autograd Function
        to the kernel's wrapper, never to the plain version: where the kernel
        cannot run, that raises (a tensor that reports itself as CUDA stands in
        for the card; the wrapper is stubbed to fail as a missing build
        would)."""

        class OnCard(torch.Tensor):
            is_cuda = property(lambda self: True)

        x = torch.zeros(1, 1, 8, 4).as_subclass(OnCard).requires_grad_(True)
        B = torch.zeros(1, 1, 8, 4)
        with mock.patch.object(ssd_cuda, "ssd_chunk_scan_cuda",
                               side_effect=RuntimeError("no kernel here")), \
                mock.patch.object(ref, "ssd_chunk_scan_ref") as plain:
            with pytest.raises(RuntimeError, match="no kernel here"):
                ops.ssd_chunk_scan(x, B, B, torch.zeros(1, 1, 8), torch.zeros(1, 1, 8), chunk=4)
        assert plain.call_count == 0
