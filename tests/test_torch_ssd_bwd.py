"""The SSD chunk scan's backward: the port's plain analytic backward
(``ref.ssd_chunk_scan_bwd_ref``) against ``jax.vjp`` of the reference's chunk
recurrence, and ``ops.ssd_chunk_scan`` as an autograd Function; the backward
kernel's launch plan (two routes) on meta tensors at every shape
``chip_smoke.py`` gives it; the tensor-core route's bf16 split of each fp32
operand, emulated in torch.

The reference's Pallas ``ssd_chunk_scan`` has no VJP (a ``pallas_call`` is not
differentiable in interpret mode), so the reference here is its own oracle,
``repro.kernels.ref.ssd_chunk_ref``, scanned over the chunks and vmapped over
batch and heads -- the recurrence the Pallas kernel computes.  Tolerance: the
SSD tests' fp32 rule (rtol = atol = 1e-4), since the products sum over up to
128 terms.  The CUDA kernel itself is held against the plain backward on the
card by ``chip_smoke.py``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as ssd_cuda

SSD_SHAPES = [            # b, H, s, P, N, chunk: the reference's tests/test_kernels.py
    (2, 2, 64, 16, 8, 16),
    (1, 4, 128, 32, 16, 32),
    (2, 1, 32, 8, 8, 32),   # single chunk
]
MANY_CHUNKS = (2, 3, 80, 8, 4, 16)   # five chunks
RTOL = ATOL = 1e-4


def inputs(seed, b, H, s, P, N, shared):
    """fp32 numpy x, B, C (B/C scaled by 0.5, (b, s, N) where shared), dt =
    softplus(n), loga = -softplus(n), as the reference's test draws them,
    and the cotangents dy and dS_final."""
    rng = np.random.default_rng(seed)
    bc = (b, s, N) if shared else (b, H, s, N)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, B, C = f(b, H, s, P), f(*bc) * 0.5, f(*bc) * 0.5
    dt = np.logaddexp(f(b, H, s), 0.0).astype(np.float32)
    loga = -np.logaddexp(f(b, H, s), 0.0).astype(np.float32)
    return (x, B, C, dt, loga), f(b, H, s, P), f(b, H, P, N)


def reference_scan(x, B, C, dt, loga, chunk):
    """(y, S_final) of the reference's ``ssd_chunk_ref`` over the chunks in
    order, every (batch, head) by vmap; B/C of shape (b, s, N) are broadcast
    to the heads, so their cotangent is the sum over the heads."""
    b, H, s, P = x.shape
    if B.ndim == 3:
        B, C = (jnp.broadcast_to(t[:, None], (b, H) + t.shape[1:]) for t in (B, C))
    step = jax.vmap(jax.vmap(jref.ssd_chunk_ref))
    S = jnp.zeros((b, H, P, B.shape[-1]), jnp.float32)
    ys = []
    for t0 in range(0, s, chunk):
        part = slice(t0, t0 + chunk)
        y, S = step(x[:, :, part], B[:, :, part], C[:, :, part], dt[:, :, part],
                    loga[:, :, part], S)
        ys.append(y)
    return jnp.concatenate(ys, axis=2), S


def reference_grads(args, dy, dS, chunk):
    _, vjp = jax.vjp(lambda *a: reference_scan(*a, chunk), *map(jnp.asarray, args))
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dS)))]


CASES = [pytest.param(*shape, shared, with_ds, id=f"{shape}-{'shared' if shared else 'per_head'}"
                      f"{'-dS' if with_ds else ''}")
         for shape in SSD_SHAPES + [MANY_CHUNKS]
         for shared, with_ds in ((False, False), (True, False), (True, True))]


class TestPlainBackward:
    @pytest.mark.parametrize("b,H,s,P,N,chunk,shared,with_ds", CASES)
    def test_matches_jax_vjp_of_the_reference_recurrence(self, b, H, s, P, N, chunk, shared,
                                                         with_ds):
        args, dy, dS = inputs(0, b, H, s, P, N, shared)
        dS = dS if with_ds else np.zeros_like(dS)
        want = reference_grads(args, dy, dS, chunk)
        got = ref.ssd_chunk_scan_bwd_ref(*map(torch.from_numpy, args), torch.from_numpy(dy),
                                         torch.from_numpy(dS) if with_ds else None, chunk)
        for name, g, w, a in zip(("dx", "dB", "dC", "ddt", "dloga"), got, want, args):
            assert g.dtype == torch.float32 and tuple(g.shape) == a.shape, name
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=name)

    @pytest.mark.parametrize("cum_dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("shared", [False, True])
    def test_matches_autograd_through_the_plain_forward(self, shared, cum_dtype):
        """The analytic backward against torch autograd through
        ``ssd_chunk_scan_ref`` itself, for either prefix-sum dtype."""
        args, dy, dS = inputs(1, *MANY_CHUNKS[:5], shared)
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
        y, S = ref.ssd_chunk_scan_ref(*leaves, MANY_CHUNKS[5], cum_dtype=cum_dtype)
        want = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                                   + (S * torch.from_numpy(dS)).sum(), leaves)
        got = ref.ssd_chunk_scan_bwd_ref(*map(torch.from_numpy, args), torch.from_numpy(dy),
                                         torch.from_numpy(dS), MANY_CHUNKS[5], cum_dtype)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)

    def test_bf16_inputs_give_gradients_in_their_dtypes(self):
        args, dy, _ = inputs(2, 1, 2, 32, 8, 4, True)
        x, B, C, dt, loga = map(torch.from_numpy, args)
        x16, B16, C16 = (t.to(torch.bfloat16) for t in (x, B, C))
        grads = ref.ssd_chunk_scan_bwd_ref(x16, B16, C16, dt, loga, torch.from_numpy(dy), None, 16)
        assert [g.dtype for g in grads] == [torch.bfloat16] * 3 + [torch.float32] * 2
        assert grads[1].shape == B.shape

    def test_shared_b_and_c_get_the_sum_of_the_per_head_gradients(self):
        args, dy, dS = inputs(3, 2, 3, 48, 8, 4, True)
        x, B, C, dt, loga = map(torch.from_numpy, args)
        H = x.shape[1]
        shared = ref.ssd_chunk_scan_bwd_ref(x, B, C, dt, loga, torch.from_numpy(dy),
                                            torch.from_numpy(dS), 16)
        per_head = ref.ssd_chunk_scan_bwd_ref(x, ref.per_head(B, H).contiguous(),
                                              ref.per_head(C, H).contiguous(), dt, loga,
                                              torch.from_numpy(dy), torch.from_numpy(dS), 16)
        for i in (0, 3, 4):
            torch.testing.assert_close(shared[i], per_head[i], rtol=0, atol=0)
        for i in (1, 2):
            torch.testing.assert_close(shared[i], per_head[i].sum(dim=1), rtol=1e-6, atol=1e-6)


class TestAutogradFunction:
    def grads(self, shared, through_ops):
        args, dy, dS = inputs(4, 2, 3, 64, 8, 4, shared)
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
        fn = ops.ssd_chunk_scan if through_ops else ref.ssd_chunk_scan_ref
        y, S = fn(*leaves, 16)
        ((y * torch.from_numpy(dy)).sum() + (S * torch.from_numpy(dS)).sum()).backward()
        return y, [t.grad for t in leaves]

    @pytest.mark.parametrize("shared", [False, True])
    def test_grad_equals_the_plain_backward(self, shared):
        """On the CPU the Function's backward is the plain analytic one:
        ``.grad`` equals it bit for bit, and autograd through the plain forward
        within the fp32 rule."""
        ops.reset_launch_counts()
        y, got = self.grads(shared, through_ops=True)
        assert type(y.grad_fn).__name__ == "_SSDChunkScanBackward"
        args, dy, dS = inputs(4, 2, 3, 64, 8, 4, shared)
        plain = ref.ssd_chunk_scan_bwd_ref(*map(torch.from_numpy, args), torch.from_numpy(dy),
                                           torch.from_numpy(dS), 16)
        for g, w in zip(got, plain):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        _, via_autograd = self.grads(shared, through_ops=False)
        for g, w in zip(got, via_autograd):
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
        assert ops.launch_counts()["ssd_chunk_scan_bwd"] == 0   # the CPU: the plain versions

    def test_a_dropped_final_state_sends_no_gradient(self):
        """S_final unused (as the model drops it): the backward gets None for
        its gradient, and the result is that of a zero dS_final."""
        args, dy, _ = inputs(5, 1, 2, 32, 8, 4, True)
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
        with mock.patch.object(ref, "ssd_chunk_scan_bwd_ref", wraps=ref.ssd_chunk_scan_bwd_ref) as bwd:
            y, _ = ops.ssd_chunk_scan(*leaves, 16)
            (y * torch.from_numpy(dy)).sum().backward()
        assert bwd.call_count == 1 and bwd.call_args.args[6] is None
        want = ref.ssd_chunk_scan_bwd_ref(*map(torch.from_numpy, args), torch.from_numpy(dy),
                                          None, 16)
        for t, w in zip(leaves, want):
            torch.testing.assert_close(t.grad, w, rtol=0, atol=0)

    def test_without_grad_the_forward_runs_alone(self):
        args, _, _ = inputs(6, 1, 2, 32, 8, 4, True)
        x = torch.from_numpy(args[0]).requires_grad_(True)
        with torch.no_grad():
            y, S = ops.ssd_chunk_scan(x, *map(torch.from_numpy, args[1:]), 16)
        assert y.grad_fn is None and S.grad_fn is None

    def test_a_cuda_tensor_goes_to_the_kernels_and_never_to_the_plain_versions(self):
        """A tensor that reports itself as CUDA stands in for the card: the
        forward goes to the forward kernel's wrapper and the backward to the
        backward kernel's (both stubbed here); the plain versions are never
        called."""

        class OnCard(torch.Tensor):
            is_cuda = property(lambda self: True)

        args, dy, _ = inputs(7, 1, 2, 32, 8, 4, True)
        x = torch.from_numpy(args[0]).as_subclass(OnCard).requires_grad_(True)
        rest = [torch.from_numpy(a) for a in args[1:]]
        seen = {}

        def fwd(*a):
            seen["fwd"] = a[5]
            return ref.ssd_chunk_scan_ref(*a)

        def bwd(*a):
            seen["bwd"] = a[7]
            return tuple(torch.zeros_like(t) for t in a[:5])

        with mock.patch.object(ssd_cuda, "ssd_chunk_scan_cuda", side_effect=fwd), \
                mock.patch.object(ssd_cuda, "ssd_chunk_scan_bwd_cuda", side_effect=bwd), \
                mock.patch.object(ref, "ssd_chunk_scan_bwd_ref") as plain_bwd:
            y, _ = ops.ssd_chunk_scan(x, *rest, 16)
            y.sum().backward()
        assert seen == {"fwd": 16, "bwd": 16} and plain_bwd.call_count == 0


class TestBackwardWrapper:
    def test_refuses_cpu_tensors(self):
        args, dy, _ = inputs(8, 1, 2, 32, 8, 4, True)
        with pytest.raises(ValueError, match="CUDA"):
            ssd_cuda.ssd_chunk_scan_bwd_cuda(*map(torch.from_numpy, args), torch.from_numpy(dy))

    @pytest.mark.parametrize("what,shape", [("chunk", (1, 2, 256, 8, 4, 256)),
                                            ("P", (1, 2, 32, 128, 4, 32)),
                                            ("N", (1, 2, 32, 8, 128, 32))])
    def test_raises_on_shapes_it_was_not_built_for(self, what, shape):
        """chunk > 128, P > 64 or N > 64: no fallback, a ValueError before the
        build (a tensor reporting itself as CUDA stands in for the card)."""

        class OnCard(torch.Tensor):
            is_cuda = property(lambda self: True)

        b, H, s, P, N, chunk = shape
        args, dy, _ = inputs(9, b, H, s, P, N, True)
        x = torch.from_numpy(args[0]).as_subclass(OnCard)
        with mock.patch.object(ssd_cuda._build, "load") as build:
            with pytest.raises(ValueError, match="the kernel takes"):
                ssd_cuda.ssd_chunk_scan_bwd_cuda(x, *map(torch.from_numpy, args[1:]),
                                                 torch.from_numpy(dy), None, chunk)
        assert build.call_count == 0


# Every SSD backward case of chip_smoke.py (kernels phase), and the training
# phases' shapes: (b, H, s, P, N, chunk, B/C shared by the heads, x's dtype,
# dy's dtype); shared cases in the model's layout, the others contiguous
PLAN_SSD_BWD = [
    (4, 80, 1024, 64, 64, 128, True, "bfloat16", "float32"),   # zamba2-2.7b's training step
    (4, 80, 1024, 64, 64, 128, True, "bfloat16", "bfloat16"),
    (4, 80, 1024, 64, 64, 128, True, "float32", "float32"),    # the launcher's fp32
    (1, 80, 384, 64, 64, 128, True, "bfloat16", "float32"),    # zamba_train_parity's 300 tokens, padded
    (1, 8, 384, 64, 64, 128, True, "float32", "float32"),
    (2, 80, 1024, 64, 64, 128, False, "bfloat16", "float32"),  # per head
    (2, 2, 64, 16, 8, 16, False, "float32", "float32"),        # the reference's shapes
    (1, 4, 128, 32, 16, 32, False, "float32", "float32"),
    (2, 1, 32, 8, 8, 32, False, "float32", "float32"),
    (2, 2, 64, 16, 8, 16, False, "bfloat16", "bfloat16"),
    (1, 4, 128, 32, 16, 32, False, "bfloat16", "bfloat16"),
    (2, 1, 32, 8, 8, 32, False, "bfloat16", "bfloat16"),
    (2, 2, 64, 16, 8, 16, True, "float32", "float32"),
    # the launcher's reduced zamba2, 64 tokens padded
    (8, 4, 128, 32, 16, 128, True, "float32", "float32"),
]


def meta_bwd(b, H, s, P, N, chunk, shared, dtype="bfloat16", dy_dtype="float32", offset=0,
             dy_offset=0):
    """``ssd_bwd_plan``'s arguments as meta tensors: shared cases in the
    model's layout (x and dy as transposed views of (b, s, H, P), B/C (b, s,
    N)), others contiguous; ``offset``/``dy_offset`` shift x's / dy's storage
    by that many elements."""
    def held(dt_, off):
        if shared:
            t = torch.empty(b * s * H * P + off, dtype=dt_, device="meta")[off:]
            return t.view(b, s, H, P).transpose(1, 2)
        return torch.empty(b * H * s * P + off, dtype=dt_, device="meta")[off:].view(b, H, s, P)

    dt_ = getattr(torch, dtype)
    x, dy = held(dt_, offset), held(getattr(torch, dy_dtype), dy_offset)
    B, C = (torch.empty((b, s, N) if shared else (b, H, s, N), dtype=dt_, device="meta")
            for _ in range(2))
    return x, B, C, dy, min(chunk, s)


def takes_tensor_cores(b, H, s, P, N, chunk, shared, dtype, dy_dtype):
    return dtype == "bfloat16" and (min(chunk, s), P, N) == (128, 64, 64)


class TestSSDBwdPlan:
    @pytest.mark.parametrize("case", PLAN_SSD_BWD)
    def test_route(self, case):
        """bf16 x/B/C at chunk 128, P = N = 64 with aligned rows take the
        tensor cores, whatever dy's dtype; fp32 and the reference's shapes the
        CUDA cores."""
        plan = ssd_cuda.ssd_bwd_plan(*meta_bwd(*case))
        assert plan.route == ("tensor_cores" if takes_tensor_cores(*case) else "cuda_cores")
        assert plan.threads == ssd_cuda.BWD_THREADS

    @pytest.mark.parametrize("case", PLAN_SSD_BWD)
    def test_groups_cover_the_heads(self, case):
        b, H, s, P, N, chunk, shared = case[:7]
        plan = ssd_cuda.ssd_bwd_plan(*meta_bwd(*case))
        hpg, G = plan.heads_per_group, plan.groups
        assert (G - 1) * hpg < H <= G * hpg   # no empty group, every head in one
        if shared:
            assert (plan.partials_per_head, plan.out_heads) == (G, 1)
        else:
            assert (hpg, G, plan.partials_per_head, plan.out_heads) == (1, H, 1, H)
        assert 1 <= plan.reduce_blocks <= ssd_cuda.REDUCE_BLOCKS_MAX

    @pytest.mark.parametrize("case", PLAN_SSD_BWD)
    def test_shared_memory_fits_a_block(self, case):
        """On either route the states pass and the chunk kernel fit a block,
        and the chunk kernel runs one block an SM."""
        from repro_torch.kernels import flash_attention as fa_cuda

        plan = ssd_cuda.ssd_bwd_plan(*meta_bwd(*case))
        assert 0 < plan.states_smem_bytes <= plan.chunk_smem_bytes <= fa_cuda.SMEM_LIMIT
        assert ssd_cuda.blocks_per_sm(plan.threads, plan.chunk_smem_bytes) == 1

    def test_tensor_core_shared_memory(self):
        """The tensor-core kernels' layouts: the chunk kernel holds x, B, C,
        dy in three bf16 terms (one where dy is bf16), S_in's or dS's three
        terms, C B^T and the group's dcb in fp32; the states kernel four blocks
        an SM."""
        tile, stile, frags = 128 * 72 * 2, 64 * 72 * 2, 36 * 16 * 16 * 4
        vectors = 4 * (5 * 128 + 8 * 128 + 4 * 128 + 8)
        for dy_dtype, terms in ((torch.float32, 3), (torch.bfloat16, 1)):
            assert ssd_cuda.bwd_dy_terms(dy_dtype) == terms
            assert ssd_cuda.bwd_tc_chunk_smem(dy_dtype) == \
                (3 + terms) * tile + 3 * stile + 2 * frags + vectors
            assert ssd_cuda.blocks_per_sm(128, ssd_cuda.bwd_tc_states_smem(dy_dtype)) >= 4
        assert ssd_cuda.bwd_tc_chunk_smem(torch.float32) == 220704

    def test_the_training_shape_fills_the_card(self):
        """At zamba2-2.7b's training step (b x chunks = 32) the chunk kernel's
        blocks fill the 132 SMs once, one block an SM (its shared memory), on
        the tensor cores."""
        b, H, s = PLAN_SSD_BWD[0][:3]
        plan = ssd_cuda.ssd_bwd_plan(*meta_bwd(*PLAN_SSD_BWD[0]))
        assert plan.route == "tensor_cores"
        blocks = plan.groups * (s // 128) * b
        assert ssd_cuda.N_SM * 0.9 <= blocks <= ssd_cuda.N_SM
        assert ssd_cuda.blocks_per_sm(plan.threads, plan.chunk_smem_bytes) == 1

    @pytest.mark.parametrize("case", [PLAN_SSD_BWD[1], PLAN_SSD_BWD[3]])
    def test_bf16_dy_and_300_tokens_fill_the_card(self, case):
        """The same with bf16 dy, and at 300 tokens padded to 384, where b x
        chunks is 3 and groups of two heads fill the card."""
        b, H, s = case[:3]
        plan = ssd_cuda.ssd_bwd_plan(*meta_bwd(*case))
        assert plan.route == "tensor_cores"
        blocks = plan.groups * (s // 128) * b
        assert ssd_cuda.N_SM * 0.9 <= blocks <= ssd_cuda.N_SM

    @pytest.mark.parametrize("what", ["fp32 x", "x offset", "dy offset", "chunk 64", "P 32",
                                      "N 32"])
    def test_other_inputs_take_the_cuda_cores(self, what):
        args = dict(b=1, H=8, s=512, P=64, N=64, chunk=128, shared=True, dtype="bfloat16",
                    dy_dtype="float32")
        args.update({"fp32 x": {"dtype": "float32"}, "chunk 64": {"chunk": 64},
                     "P 32": {"P": 32}, "N 32": {"N": 32}}.get(what, {}))
        plan = ssd_cuda.ssd_bwd_plan(*meta_bwd(**args, offset=int(what == "x offset"),
                                               dy_offset=int(what == "dy offset")))
        assert plan.route == "cuda_cores"

    def test_groups_rule(self):
        assert ssd_cuda.groups_for(80, 32, 132) == 4     # 128 blocks of 20 heads
        assert ssd_cuda.groups_for(80, 132, 132) == 1    # the chunks alone fill the card
        assert ssd_cuda.groups_for(80, 32, 132, ssd_cuda.BWD_TC_BLOCK_COST) == 4
        assert ssd_cuda.groups_for(80, 3, 132, ssd_cuda.BWD_TC_BLOCK_COST) == 40
        for units in (1, 3, 8, 50):
            g = ssd_cuda.groups_for(80, units, 132)
            hpg = -(-80 // g)
            assert (g - 1) * hpg < 80 <= g * hpg

    @staticmethod
    def layout(plan):
        return [ssd_cuda.ROUTES.index(plan.route), plan.heads_per_group, plan.groups,
                plan.threads, plan.states_smem_bytes, plan.chunk_smem_bytes,
                plan.reduce_blocks, plan.partials_per_head, plan.out_heads]

    def test_plan_array_layout(self):
        plan = ssd_cuda.ssd_bwd_plan(*meta_bwd(*PLAN_SSD_BWD[0]))
        assert list(plan.as_array()) == self.layout(plan)
        assert plan.as_array()[0] == 1   # tensor cores
        assert len(plan.as_array()) == ssd_cuda.BWD_PLAN_LEN

    def test_plan_array_layout_cuda_cores(self):
        plan = ssd_cuda.ssd_bwd_plan(*meta_bwd(*PLAN_SSD_BWD[2]))
        assert list(plan.as_array()) == self.layout(plan)
        assert plan.as_array()[0] == 0
        assert len(plan.as_array()) == ssd_cuda.BWD_PLAN_LEN


class TestSSDBwdSplitPrecision:
    """Why the backward's tensor-core route splits each fp32 operand into
    three bf16 terms, as the forward does (``test_torch_kernels.py::
    TestSSDSplitPrecision``), on the same chunk, whose prefix sum passes |cum|
    = 100: each product that takes an fp32 operand, emulated with bf16
    rounding (each product of terms exact, as the tensor cores form it in
    fp32), against the exact product, by the 1e-4 rule (rtol = atol).  One
    term misses it by far; two meet it with little margin (up to 0.95 of the
    allowance, dy S_in and dy x^T); three sit at fp32 level.  Where both
    operands are fp32 the products of terms i + j <= 2 run (six of nine).  dy
    in bf16 is exact: one term."""

    @staticmethod
    def chunk():
        rng = np.random.default_rng(0)
        cs, P, N = 128, 64, 64
        loga = -np.abs(rng.standard_normal(cs) * 0.5 + 0.78).astype(np.float32)
        dt = np.logaddexp(rng.standard_normal(cs), 0.0).astype(np.float32)
        C, B = (rng.standard_normal((cs, N)).astype(np.float32) * 0.5 for _ in range(2))
        x = rng.standard_normal((cs, P)).astype(np.float32)
        C, B, x = (torch.from_numpy(a).bfloat16().float() for a in (C, B, x))
        dt = torch.from_numpy(dt)
        cum = torch.cumsum(torch.from_numpy(loga).double(), 0).float()
        tri = torch.ones(cs, cs, dtype=torch.bool).tril()
        gate = torch.where(tri, torch.exp(torch.where(tri, cum[:, None] - cum[None, :], 0.0)), 0.0)
        # the cotangents and the states, fp32 from a second seed
        rng = np.random.default_rng(1)
        dy, S, dS = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                     for shape in ((cs, P), (P, N), (P, N)))
        gcb = gate * (C @ B.T)
        dW = (dy.double() @ x.double().T).float()
        dcb = dW * gate * dt[None, :]
        w = torch.exp(cum[-1] - cum) * dt
        dy16 = dy.bfloat16().float()
        # name: (A, B, A fp32?, B fp32?), each product as the kernels form it
        return cum, {
            "dW^T = x dy^T": (x, dy.T, False, True),
            "gcb^T dy": (gcb.T, dy, True, True),
            "dy S_in": (dy, S, True, True),
            "dS B^T": (B, dS.T, False, True),
            "x dS": (x, dS, False, True),
            "dcb^T C": (dcb.T, C, True, False),
            "dcb B": (dcb, B, True, False),
            "(x w)^T B": ((x * w[:, None]).T, B, True, False),
            "(exp(cum) dy)^T C": ((dy * torch.exp(cum)[:, None]).T, C, True, False),
            "gcb^T dy, dy bf16": (gcb.T, dy16, True, False),
            "dy S_in, dy bf16": (dy16, S, False, True),
        }

    @staticmethod
    def terms(v, k):
        out = []
        for _ in range(k):
            out.append(v.bfloat16().float())
            v = v - out[-1]
        return out

    def ratio(self, a, b, ka, kb):
        """The worst |got - exact| / (1e-4 (1 + |exact|)) with ``ka``/``kb``
        terms of a and b (0: the operand as it is, exact in bf16); both split:
        the products of terms i + j < max(ka, kb)."""
        A = self.terms(a, ka) if ka else [a]
        Bt = self.terms(b, kb) if kb else [b]
        top = max(len(A), len(Bt))
        got = sum(ai.double() @ bj.double() for i, ai in enumerate(A) for j, bj in enumerate(Bt)
                  if i + j < top)
        exact = a.double() @ b.double()
        return ((got - exact).abs() / (1e-4 * (1 + exact.abs()))).max().item()

    PRODUCTS = ["dW^T = x dy^T", "gcb^T dy", "dy S_in", "dS B^T", "x dS", "dcb^T C", "dcb B",
                "(x w)^T B", "(exp(cum) dy)^T C", "gcb^T dy, dy bf16", "dy S_in, dy bf16"]

    @pytest.mark.parametrize("name", PRODUCTS)
    @pytest.mark.parametrize("k,lo,hi", [(1, 1.0, np.inf), (2, 0.0, 1.0),
                                         (ssd_cuda.BWD_TERMS, 0.0, 1e-2)])
    def test_terms_against_the_rule(self, name, k, lo, hi):
        cum, products = self.chunk()
        assert cum[-1].abs() > 100
        a, b, a32, b32 = products[name]
        ratio = self.ratio(a, b, k if a32 else 0, k if b32 else 0)
        assert lo < ratio <= hi

    def test_the_kernel_term_counts(self):
        """Three terms of every fp32 operand; dy's count by its dtype."""
        assert ssd_cuda.BWD_TERMS == 3
        assert ssd_cuda.bwd_dy_terms(torch.float32) == 3
        assert ssd_cuda.bwd_dy_terms(torch.bfloat16) == 1


class TestOverflowingGate:
    """Above the diagonal exp(cum_t - cum_u) overflows once a chunk's decay
    passes ~88 (zamba2-2.7b at full width: A down to -80).  The forward selects
    the exponent before exp, so autograd through the plain forward and the
    analytic backward both stay finite (``where(tri, exp(decay), 0)`` alone
    would give 0 * inf = NaN in the backward)."""

    def test_gradients_stay_finite_and_agree(self):
        args, dy, dS = inputs(10, 1, 2, 64, 8, 4, True)
        args = (*args[:4], args[4] * 8.0)              # |cum| reaches hundreds within a chunk
        assert np.cumsum(args[4][..., :32], axis=-1).min() < -100
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
        y, S = ref.ssd_chunk_scan_ref(*leaves, 32)
        want = torch.autograd.grad((y * torch.from_numpy(dy)).sum()
                                   + (S * torch.from_numpy(dS)).sum(), leaves)
        got = ref.ssd_chunk_scan_bwd_ref(*map(torch.from_numpy, args), torch.from_numpy(dy),
                                         torch.from_numpy(dS), 32)
        for g, w in zip(got, want):
            assert torch.isfinite(w).all() and torch.isfinite(g).all()
            torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
