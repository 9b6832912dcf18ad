"""The port's MoE against the reference's, on the CPU and the same numpy
inputs: ``layers.moe_fwd`` (routing decisions, output, aux and every
gradient), the properties of ``tests/test_moe.py``, and the MoE family of
``DecoderLM`` (reduced qwen3-moe-235b-a22b and dbrx-132b): forward, loss and
gradients, paged prefill and decode, and the launcher.

Tolerances: the reference's (``tests/test_kernels.py``): fp32 1e-5, bf16
2e-2, each times the largest |element| of the reference's result (a gradient
leaf, an output); the aux loss within 1e-6.  Routing decisions (each (token,
k)'s expert and whether it is kept) must be identical before anything else
is compared, except in a whole bf16-compute model, where the two sides'
rounding flips near-ties (the rule at ``held_positions``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.train import loss_and_grads as jax_loss_and_grads
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_layout
from repro_torch.data import SyntheticDataset
from repro_torch.launch import train as launch_train
from repro_torch.models import ModelOptions, build_model
from repro_torch.models import layers as TL
from repro_torch.train import loss_and_grads

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
N_PAGES, PS, MAX_BLOCKS = 12, 4, 6


def jax_tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def close(got, want, tol, what=""):
    """``got`` within ``tol`` times the largest |element| of ``want``."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max() + 1e-12,
                               err_msg=what)


def jax_routing(p, x, top_k, capacity_factor, group_size):
    """The reference's routing decisions, the lines of its ``moe_fwd`` that
    make them: (expert_idx, keep), each (G, gs, k)."""
    b, s, d = x.shape
    E = p["router"].shape[-1]
    n = b * s
    gs = min(group_size, n)
    while n % gs:
        gs //= 2
    xt = x.reshape(n // gs, gs, d)
    probs = jax.nn.softmax(jnp.einsum("gtd,de->gte", xt.astype(jnp.float32), p["router"]), -1)
    _, expert_idx = jax.lax.top_k(probs, top_k)
    capacity = max(4, int(np.ceil(top_k * gs / E * capacity_factor)))
    onehot = jax.nn.one_hot(expert_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(n // gs, gs * top_k, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape) * onehot, axis=-1)
    return np.asarray(expert_idx), np.asarray(pos < capacity)


def moe_inputs(E, d, ff, b, s, seed=0):
    p = JL.init_moe(jax.random.PRNGKey(seed), d, E, ff, jnp.float32)
    x = np.random.default_rng(seed + 1).standard_normal((b, s, d)).astype(np.float32)
    return jax_tree_np(p), x


def port_moe(p, dtype, requires_grad=False):
    """The port's tree of the reference's numpy MoE params: the router fp32,
    the experts in ``dtype``."""
    return {n: torch.tensor(w, dtype=torch.float32 if n == "router" else getattr(torch, dtype),
                            requires_grad=requires_grad) for n, w in p.items()}


# (E, top_k, b, s, group_size, capacity_factor): one, few and many experts;
# top-1, 2 and 8; groups that split the tokens (several groups, a size halved
# to divide them) and that do not; capacity that drops most pairs, some and none
MOE_CASES = [
    (1, 1, 1, 8, 8, 4.0),
    (4, 1, 2, 32, 16, 1.25),
    (4, 2, 2, 32, 16, 1.25),
    (4, 2, 1, 24, 16, 8.0),      # 24 tokens: the group halves to 8
    (16, 2, 1, 64, 512, 8.0),    # one group
    (16, 8, 2, 48, 512, 0.01),   # 96 tokens: 3 groups of 32, capacity 4
    (16, 8, 2, 64, 32, 1.25),
    (16, 2, 4, 16, 16, 0.01),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,top_k,b,s,gs,cf", MOE_CASES)
def test_moe_fwd_matches_the_reference(E, top_k, b, s, gs, cf, dtype):
    d, ff = 16, 32
    p, x = moe_inputs(E, d, ff, b, s, seed=E + top_k)
    pj = {n: jnp.asarray(w, jnp.float32 if n == "router" else JDT[dtype]) for n, w in p.items()}
    xj = jnp.asarray(x, JDT[dtype])

    def jax_loss(pp, xx):
        out, aux = JL.moe_fwd(pp, xx, top_k=top_k, capacity_factor=cf, group_size=gs,
                              return_aux=True)
        return (out.astype(jnp.float32) ** 2).mean() + aux, (out, aux)

    (_, (out_j, aux_j)), (g_j, gx_j) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(pj, xj)

    pt = port_moe(p, dtype, requires_grad=True)
    xt = torch.tensor(x).to(getattr(torch, dtype)).requires_grad_(True)
    gs_used, capacity = TL.moe_groups(b * s, E, top_k, cf, gs)
    logits = xt.detach().float().reshape(-1, gs_used, d) @ pt["router"].detach()
    _, _, idx_t, _, keep_t = TL.moe_route(logits, top_k, capacity)
    idx_j, keep_j = jax_routing(pj, xj, top_k, cf, gs)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    if cf < 0.1:
        assert not keep_j.all()   # the small capacity drops pairs

    out_t, aux_t = TL.moe_fwd(pt, xt, top_k=top_k, capacity_factor=cf, group_size=gs,
                              return_aux=True)
    ((out_t.float() ** 2).mean() + aux_t).backward()
    tol = TOL[dtype]
    assert out_t.dtype == xt.dtype and aux_t.dtype == torch.float32
    close(out_t, out_j, tol, "out")
    assert abs(aux_t.item() - float(aux_j)) <= 1e-6 * max(1.0, abs(float(aux_j)))
    close(xt.grad, gx_j, tol, "dx")
    for name in p:
        assert pt[name].grad.dtype == pt[name].dtype
        close(pt[name].grad, g_j[name], tol, name)


class TestMoEProperties:
    """The port's counterparts of the reference's ``tests/test_moe.py``."""

    def test_matches_ungrouped_when_capacity_ample(self):
        p, x = moe_inputs(4, 16, 32, 2, 16)
        pt, xt = port_moe(p, "float32"), torch.tensor(x) * 0.5
        outs = [TL.moe_fwd(pt, xt, top_k=2, capacity_factor=8.0, group_size=gs)
                for gs in (8, 16, 32)]
        for other in outs[1:]:
            torch.testing.assert_close(outs[0], other, rtol=1e-5, atol=1e-5)

    def test_single_expert_equals_dense_mlp(self):
        p, x = moe_inputs(1, 12, 24, 1, 8)
        pt, xt = port_moe(p, "float32"), torch.tensor(x) * 0.5
        out = TL.moe_fwd(pt, xt, top_k=1, capacity_factor=4.0, group_size=8)
        mlp = {n: pt[n][0] for n in ("w_gate", "w_in", "w_out")}
        torch.testing.assert_close(out, TL.mlp_fwd(mlp, xt), rtol=1e-4, atol=1e-5)

    def test_capacity_drops_tokens(self):
        p, x = moe_inputs(4, 8, 16, 1, 64)
        pt, xt = port_moe(p, "float32"), torch.tensor(x)
        full = TL.moe_fwd(pt, xt, top_k=2, capacity_factor=8.0, group_size=64)
        tiny = TL.moe_fwd(pt, xt, top_k=2, capacity_factor=0.01, group_size=64)
        assert float(tiny.abs().mean()) < float(full.abs().mean())
        # capacity 4 a group: at most 4 pairs an expert, so at most 16 tokens are touched
        assert int((tiny.abs().sum(-1) > 0).sum()) <= 16

    @pytest.mark.parametrize("tokens,E,top_k", [(8, 2, 1), (16, 4, 2), (32, 8, 2), (8, 8, 1)])
    def test_combine_weights_bounded(self, tokens, E, top_k):
        p, x = moe_inputs(E, 8, 16, 1, tokens, seed=tokens * 31 + E)
        out = TL.moe_fwd(port_moe(p, "float32"), torch.tensor(x), top_k=top_k,
                         capacity_factor=8.0, group_size=tokens)
        assert torch.isfinite(out).all()

    def test_aux_loss_balanced_router_is_one_and_ties_take_the_lower_expert(self):
        p, x = moe_inputs(4, 8, 16, 2, 32)
        pt = port_moe(p, "float32")
        pt["router"] = torch.zeros(8, 4)   # uniform probabilities: every choice a tie
        _, aux = TL.moe_fwd(pt, torch.tensor(x), top_k=1, capacity_factor=4.0, group_size=32,
                            return_aux=True)
        assert 0.9 < float(aux) < 1.1
        _, gates, idx, _, _ = TL.moe_route(torch.zeros(2, 32, 8), 3, 100)
        assert (idx == torch.tensor([0, 1, 2])).all()   # as jax.lax.top_k orders ties
        torch.testing.assert_close(gates, torch.full((2, 32, 3), 1 / 3))

    def test_grad_flows_to_experts_and_router(self):
        p, x = moe_inputs(4, 8, 16, 1, 16)
        pt = port_moe(p, "float32", requires_grad=True)
        (TL.moe_fwd(pt, torch.tensor(x), top_k=2, capacity_factor=2.0, group_size=16) ** 2).sum().backward()
        for name in ("router", "w_gate", "w_in", "w_out"):
            assert float(pt[name].grad.abs().max()) > 0.0, name

    def test_an_expert_with_no_token_gets_a_zero_gradient(self):
        """As ``jax.grad`` gives; ``loss_and_grads`` refuses a None."""
        p, x = moe_inputs(4, 8, 16, 1, 16)
        p["router"] = p["router"].copy()
        p["router"][:, 3] = -10.0   # on positive inputs, expert 3 is always last
        pt = port_moe(p, "float32", requires_grad=True)
        out, aux = TL.moe_fwd(pt, torch.tensor(np.abs(x)), top_k=2, capacity_factor=2.0,
                              group_size=16, return_aux=True)
        ((out ** 2).sum() + aux).backward()
        for name in ("w_gate", "w_in", "w_out"):
            assert pt[name].grad is not None
            assert float(pt[name].grad[3].abs().max()) == 0.0, name
            assert float(pt[name].grad[:3].abs().max()) > 0.0, name

    def test_two_calls_agree_bit_for_bit(self):
        p, x = moe_inputs(16, 16, 32, 2, 64)
        grads = []
        for _ in range(2):
            pt = port_moe(p, "bfloat16", requires_grad=True)
            xt = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
            out, aux = TL.moe_fwd(pt, xt, top_k=8, capacity_factor=1.25, return_aux=True)
            ((out.float() ** 2).sum() + aux).backward()
            grads.append([out, aux, xt.grad] + [pt[n].grad for n in sorted(pt)])
        for a, b in zip(*grads):
            assert torch.equal(a, b)

    def test_route_takes_given_choices(self):
        """``expert_idx`` given: the gates are those experts' renormalised
        probabilities and the queue positions are counted for them."""
        logits = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 16, 8)).astype(np.float32))
        own = TL.moe_route(logits, 2, 4)
        for a, b in zip(own, TL.moe_route(logits, 2, 4, own[2])):
            assert torch.equal(a, b)
        flipped = own[2].flip(-1)
        probs, gates, idx, pos, keep = TL.moe_route(logits, 2, 4, flipped)
        assert torch.equal(idx, flipped) and torch.equal(gates, own[1].flip(-1))
        for g in range(2):   # earlier pairs of the group that chose the same expert
            seen = {}
            for t in range(16):
                for k in range(2):
                    e = int(idx[g, t, k])
                    assert int(pos[g, t, k]) == seen.get(e, 0)
                    seen[e] = seen.get(e, 0) + 1
        assert torch.equal(keep, pos < 4)

    def test_init_moe_keeps_the_router_fp32(self):
        p = TL.init_moe(torch.Generator().manual_seed(0), 8, 4, 16, dtype=torch.bfloat16)
        assert p["router"].dtype == torch.float32 and p["w_gate"].dtype == torch.bfloat16
        assert p["w_gate"].shape == (4, 8, 16) and p["w_out"].shape == (4, 16, 8)


# --------------------------------------------------------------- the model
MOE_ARCHS = ["qwen3-moe-235b-a22b", "dbrx-132b"]


def model_pair(arch, compute="float32", seed=0):
    cfg_j, cfg_t = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jm = jax_build_model(cfg_j, JaxOptions(compute_dtype=compute, remat=False))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg_t, ModelOptions("float32", compute, remat=False), device="cpu")
    tp = from_jax_params(jax_tree_np(jp), cfg_t, torch.float32, "cpu")
    return jm, jp, tm, tp


@pytest.fixture(scope="module", params=MOE_ARCHS)
def pair(request):
    return model_pair(request.param)


def recorded_routes(monkeypatch, jm, tm):
    """Route recorders on both sides' ``moe_fwd``: each call appends the
    (expert_idx, keep) of its input, flattened to (tokens, k)."""
    seen = {"jax": [], "torch": []}
    jax_fwd, port_fwd = JL.moe_fwd, TL.moe_fwd

    def jax_rec(p, x, **kw):
        idx, keep = jax_routing(p, x, kw["top_k"], kw["capacity_factor"], 512)
        seen["jax"].append((idx.reshape(-1, kw["top_k"]), keep.reshape(-1, kw["top_k"])))
        return jax_fwd(p, x, **kw)

    def port_rec(p, x, **kw):
        n = x.shape[0] * x.shape[1]
        gs, capacity = TL.moe_groups(n, p["router"].shape[-1], kw["top_k"], kw["capacity_factor"])
        logits = x.detach().float().reshape(n // gs, gs, -1) @ p["router"].detach()
        _, _, idx, _, keep = TL.moe_route(logits, kw["top_k"], capacity)
        seen["torch"].append((idx.reshape(-1, kw["top_k"]).numpy(),
                              keep.reshape(-1, kw["top_k"]).numpy()))
        return port_fwd(p, x, **kw)

    monkeypatch.setattr(JL, "moe_fwd", jax_rec)
    monkeypatch.setattr(TL, "moe_fwd", port_rec)
    return seen


def held_positions(seen, b, s):
    """(b, s) mask of the positions whose routes, and those of every earlier
    position of their sequence, agree in every layer: the positions whose
    logits the same arithmetic computes on both sides.  A flipped route
    changes its token's output, every later token of its sequence through
    attention, and through capacity the kept pairs of later tokens of its
    group (those show as flipped routes too)."""
    agree = np.ones(b * s, bool)
    assert len(seen["jax"]) == len(seen["torch"]) > 0
    for (ij, kj), (it, kt) in zip(seen["jax"], seen["torch"]):
        agree &= ((ij == it) & (kj == kt)).all(-1)
    return np.logical_and.accumulate(agree.reshape(b, s), axis=1)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux_match_the_reference(arch, compute, monkeypatch):
    """fp32: every route identical, all logits within 1e-5.  bf16 compute:
    the two sides round attention and RMSNorm differently, and a normed input
    one bf16 step apart can flip a near-tie of the router, so the logits are
    held at the positions ``held_positions`` keeps (at least the first of
    each sequence) and the aux loss within 2e-2."""
    cfg_j, cfg_t = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jm = jax_build_model(cfg_j, JaxOptions(compute_dtype=compute, remat=False, scan_layers=False))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg_t, ModelOptions("float32", compute, remat=False), device="cpu")
    tp = from_jax_params(jax_tree_np(jp), cfg_t, torch.float32, "cpu")
    seen = recorded_routes(monkeypatch, jm, tm)
    tokens = np.random.default_rng(0).integers(0, cfg_t.vocab, (2, 24)).astype(np.int32)
    want, aux_j = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got, aux_t = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    held = held_positions(seen, 2, 24)
    assert len(seen["torch"]) == cfg_t.n_layers
    if compute == "float32":
        assert held.all()
    assert held[:, 0].all()
    v = cfg_t.vocab
    close(got.float().numpy()[held][:, :v], np.asarray(want, np.float32)[held][:, :v],
          TOL[compute], "logits")
    assert aux_t.dtype == torch.float32 and float(aux_t) > 0
    aux_tol = 1e-6 if compute == "float32" else TOL[compute]
    assert abs(float(aux_t) - float(aux_j)) <= aux_tol * float(aux_j)


@pytest.mark.parametrize("weights", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,remat,microbatches", [
    ("qwen3-moe-235b-a22b", False, 1), ("qwen3-moe-235b-a22b", True, 2), ("dbrx-132b", True, 1)])
def test_loss_and_every_gradient_match_the_reference(arch, remat, microbatches, weights):
    """fp32 compute (the launcher's) on fp32 or bf16 weights (the router
    fp32 either way): every route identical, the loss and ce within 1e-5, the
    aux within 1e-6, every gradient leaf within 1e-5 (fp32 weights) or 2e-2
    (bf16: both sides round the same fp32 gradient sums differently) of its
    largest element.  bf16 compute is held leaf by leaf in
    ``test_moe_fwd_matches_the_reference``; at the model its routes flip."""
    cfg_j, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jm = jax_build_model(cfg_j, JaxOptions(compute_dtype="float32", remat=remat))
    jp = jax_tree_np(jm.init(jax.random.PRNGKey(1)))
    dtype = getattr(torch, weights)
    params = from_jax_params(jp, cfg, dtype, "cpu")
    if dtype == torch.bfloat16:   # the reference on the same rounded weights, held in bf16
        jp = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(a, jnp.float32 if jax.tree_util.keystr(path).endswith(
                ("['norm_scale']", "['router']")) else jnp.bfloat16), to_jax_layout(params, cfg))
    tm = build_model(cfg, ModelOptions(weights, "float32", remat=remat), device="cpu")
    batch = SyntheticDataset(cfg.vocab, 32, 4, seed=3).batch(0)
    batch["labels"][0, :5] = -1
    jloss, jmetrics, jgrads = jax_loss_and_grads(
        jm, jp, {k: jnp.asarray(v) for k, v in batch.items()}, microbatches)
    loss, metrics, grads = loss_and_grads(
        tm, params, {k: torch.from_numpy(v) for k, v in batch.items()}, microbatches)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(metrics["ce"]) == pytest.approx(float(jmetrics["ce"]), rel=1e-5)
    assert float(metrics["aux"]) == pytest.approx(float(jmetrics["aux"]), rel=1e-6)
    assert float(metrics["aux"]) > 0
    got, want = to_jax_layout(grads, cfg), jax_tree_np(jgrads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        close(g, w, TOL[weights], jax.tree_util.keystr(path))
    assert float(np.abs(got["layers"]["moe"]["router"]).max()) > 0


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


def test_prefill_paged_matches_the_reference(pair):
    """The bucket's padding positions route and take capacity, as in the
    reference: the real positions' logits agree."""
    jm, jp, tm, tp = pair
    prompt = np.random.default_rng(0).integers(0, tm.cfg.vocab, 11)
    table = np.array([7, 2, 4, -1, -1, -1], np.int32)
    got, want, pages_t, pages_j = _prefill_both(jm, jp, tm, tp, prompt, 16, table)
    close(got[0, :11], np.asarray(want)[0, :11], 1e-5, "prefill logits")
    for n in ("k", "v"):
        close(pages_t[n][:, :N_PAGES], pages_j[n], 1e-5, n)


def test_decode_step_paged_matches_the_reference(pair):
    """Inactive lanes route and take capacity too: every lane's logits agree."""
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, tm.cfg.vocab, 7)
    tables = np.full((3, MAX_BLOCKS), -1, np.int32)
    tables[1, :3] = [5, 0, 9]
    _, _, pages_t, pages_j = _prefill_both(jm, jp, tm, tp, prompt, 8, tables[1])
    active = np.array([False, True, False])
    for step in range(3):
        lengths = np.array([0, 7 + step, 0], np.int32)
        tokens = rng.integers(0, tm.cfg.vocab, (3, 1)).astype(np.int32)
        want, pages_j = jm.decode_step_paged(
            jp, pages_j, jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(tokens),
            jnp.asarray(active))
        with torch.no_grad():
            got, pages_t = tm.decode_step_paged(
                tp, pages_t, torch.from_numpy(tables), torch.from_numpy(lengths),
                torch.from_numpy(tokens), torch.from_numpy(active))
        close(got, np.asarray(want), 1e-5, f"decode step {step}")


def test_decode_step_dense_matches_the_reference(pair):
    jm, jp, tm, tp = pair
    rng = np.random.default_rng(2)
    cache_j, cache_t = jm.init_cache(2, 8), tm.init_cache(2, 8)
    for _ in range(4):
        tokens = rng.integers(0, tm.cfg.vocab, (2, 1)).astype(np.int32)
        want, cache_j = jm.decode_step(jp, cache_j, jnp.asarray(tokens))
        with torch.no_grad():
            got, cache_t = tm.decode_step(tp, cache_t, torch.from_numpy(tokens))
        close(got, np.asarray(want), 1e-5, "dense decode")


def test_converter_carries_the_moe_both_ways(pair):
    _, jp, tm, tp = pair
    want = jax_tree_np(jp)
    for name, w in tp["layers"][1]["moe"].items():
        np.testing.assert_array_equal(w.numpy(), want["layers"]["moe"][name][1])
    bf16 = from_jax_params(want, tm.cfg, torch.bfloat16, "cpu")
    assert bf16["layers"][0]["moe"]["router"].dtype == torch.float32   # routes decided in fp32
    assert bf16["layers"][0]["moe"]["w_in"].dtype == torch.bfloat16
    back = to_jax_layout(tp, tm.cfg)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def test_init_has_the_converted_structure(pair):
    _, _, tm, tp = pair
    own = tm.init(torch.Generator().manual_seed(0))

    def sig(tree):
        if isinstance(tree, dict):
            return {k: sig(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [sig(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert sig(own) == sig(tp)


def test_capacity_factor_option_overrides_the_config():
    jm, jp, tm, tp = model_pair("qwen3-moe-235b-a22b")
    small = build_model(tm.cfg, ModelOptions("float32", "float32", remat=False,
                                             moe_capacity_factor=0.01), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (2, 32)).astype(np.int32))
    with torch.no_grad():
        a, _ = tm.forward(tp, {"tokens": tokens})
        b, _ = small.forward(tp, {"tokens": tokens})
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launcher_trains_on_the_cpu(arch, tmp_path, capsys):
    rc = launch_train.main(["--arch", arch, "--device", "cpu", "--steps", "16", "--log-every", "4",
                            "--ckpt-every", "8", "--ckpt-dir", str(tmp_path)])
    assert rc == 0   # the launcher's own rule: the last logged loss below the first
    assert "done: first logged loss" in capsys.readouterr().out
