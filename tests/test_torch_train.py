"""The port's training slice against the reference's, on the CPU and the same
numpy inputs: the data stream (bit for bit), the LR schedules, AdamW, the
loss and its gradients on reduced models (fp32), the trainer's loss history,
checkpoint-restart and the launcher.

Tolerances: the schedules' float32 ``cos``/``pow`` may differ by an ulp
between numpy and XLA (rtol 1e-6); AdamW is the same float32 arithmetic in
the same order, up to the global norm's order of summation (rtol 1e-6, atol
1e-9); the loss within 1e-5 and each gradient leaf within 1e-4 of its largest
element (sums in other orders over a few layers); the 12-step loss history
within 1e-4 (AdamW's sqrt(v) amplifies differences in near-zero gradients).
"""

import dataclasses
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_get_config
from repro.data import Prefetcher as JaxPrefetcher
from repro.data import SyntheticDataset as JaxDataset
from repro.models import ModelOptions as JaxOptions
from repro.models import build_model as jax_build_model
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import get_schedule as jax_get_schedule
from repro.optim import init_opt_state as jax_init_opt_state
from repro.train import Trainer as JaxTrainer
from repro.train import TrainerConfig as JaxTrainerConfig
from repro.train import loss_and_grads as jax_loss_and_grads
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_layout
from repro_torch.data import Prefetcher, SyntheticDataset
from repro_torch.launch import train as launch_train
from repro_torch.models import ModelOptions, build_model
from repro_torch.optim import AdamWConfig, adamw_update, get_schedule, init_opt_state
from repro_torch.train import FaultInjector, Trainer, TrainerConfig, loss_and_grads

FP32 = dict(param_dtype="float32", compute_dtype="float32")


def jax_tree_np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def assert_trees_close(got: dict, want: dict, rel: float, path: str = ""):
    """Every leaf of ``got`` within ``rel`` times the largest |element| of
    the same leaf of ``want``."""
    assert got.keys() == want.keys(), path
    for k in got:
        if isinstance(got[k], dict):
            assert_trees_close(got[k], want[k], rel, f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape, f"{path}/{k}"
            np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max() + 1e-12,
                                       err_msg=f"{path}/{k}")


# --------------------------------------------------------------------- data
class TestData:
    @pytest.mark.parametrize("vocab,seq,batch,seed", [(512, 16, 4, 0), (1000, 33, 3, 7),
                                                      (122753, 64, 2, 0)])
    def test_batches_are_bit_identical(self, vocab, seq, batch, seed):
        mine, theirs = SyntheticDataset(vocab, seq, batch, seed), JaxDataset(vocab, seq, batch, seed)
        np.testing.assert_array_equal(mine.lm.succ, theirs.lm.succ)
        np.testing.assert_array_equal(mine.lm.probs, theirs.lm.probs)
        for step in (0, 1, 5, 123):
            a, b = mine.batch(step), theirs.batch(step)
            assert a.keys() == b.keys() == {"tokens", "labels"}
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])

    def test_prefetcher_streams_the_same_steps(self):
        mine, theirs = Prefetcher(SyntheticDataset(512, 8, 2), start_step=3), \
            JaxPrefetcher(JaxDataset(512, 8, 2), start_step=3)
        try:
            for _ in range(4):
                (sa, a), (sb, b) = mine.next(), theirs.next()
                assert sa == sb
                np.testing.assert_array_equal(a["tokens"], b["tokens"])
        finally:
            mine.close()
            theirs.close()
        assert not mine._thread.is_alive()


# ---------------------------------------------------------------- schedules
class TestSchedules:
    @pytest.mark.parametrize("name", ["cosine", "wsd"])
    @pytest.mark.parametrize("peak,warmup,total", [(3e-3, 10, 200), (1e-3, 1, 8), (3e-4, 0, 50),
                                                   (1e-2, 5, 5)])
    def test_every_step_agrees(self, name, peak, warmup, total):
        mine = get_schedule(name, peak, warmup, total)
        theirs = jax_get_schedule(name, peak, warmup, total)
        steps = range(total + 3)
        got = np.array([mine(s) for s in steps], np.float32)
        want = np.array([float(theirs(s)) for s in steps], np.float32)
        assert all(isinstance(mine(s), float) for s in steps)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)

    def test_unknown_schedule_raises(self):
        with pytest.raises(ValueError):
            get_schedule("linear", 1e-3, 1, 10)


# -------------------------------------------------------------------- AdamW
def adamw_inputs(seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 2)}}

    def draw(scale):
        return jax.tree.map(lambda s: (rng.standard_normal(s) * scale).astype(np.float32), shapes,
                            is_leaf=lambda s: isinstance(s, tuple))

    return draw(1.0), [draw(g) for g in (0.3, 3.0, 0.01)]


class TestAdamW:
    @pytest.mark.parametrize("clip", [0.0, 1.0])
    @pytest.mark.parametrize("lr", [1e-2, "wsd"])
    def test_three_steps_agree(self, clip, lr):
        p0, grads = adamw_inputs(0)
        sched = (lambda name: (get_schedule(name, 1e-2, 1, 3), jax_get_schedule(name, 1e-2, 1, 3)))
        lr_t, lr_j = sched("wsd") if lr == "wsd" else (lr, lr)
        cfg_t, cfg_j = AdamWConfig(lr=lr_t, grad_clip=clip), JaxAdamW(lr=lr_j, grad_clip=clip)
        pt = jax.tree.map(torch.tensor, p0)
        pj = jax.tree.map(jnp.asarray, p0)
        st, sj = init_opt_state(pt), jax_init_opt_state(pj)
        for g in grads:
            pt, st, mt = adamw_update(pt, jax.tree.map(torch.tensor, g), st, cfg_t)
            pj, sj, mj = jax_adamw_update(pj, jax.tree.map(jnp.asarray, g), sj, cfg_j)
            assert mt["lr"] == pytest.approx(float(mj["lr"]), rel=1e-6)
            assert float(mt["grad_norm"]) == pytest.approx(float(mj["grad_norm"]), rel=1e-6)
        assert st["step"] == int(sj["step"]) == 3
        for got, want in ((pt, pj), (st["m"], sj["m"]), (st["v"], sj["v"])):
            np.testing.assert_allclose(
                np.concatenate([t.numpy().ravel() for t in jax.tree.leaves(got)]),
                np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(want)]),
                rtol=1e-6, atol=1e-9)

    def test_update_is_in_place_and_clips_the_grads(self):
        p0, grads = adamw_inputs(1)
        pt = jax.tree.map(torch.tensor, p0)
        ptr = pt["a"].data_ptr()
        g = jax.tree.map(torch.tensor, grads[1])
        norm = float(torch.sqrt(sum((t ** 2).sum() for t in jax.tree.leaves(g))))
        st = init_opt_state(pt)
        out, st, m = adamw_update(pt, g, st, AdamWConfig(lr=1e-2, grad_clip=1.0))
        assert out is pt and pt["a"].data_ptr() == ptr
        assert float(m["grad_norm"]) == pytest.approx(norm, rel=1e-6)
        clipped = float(torch.sqrt(sum((t ** 2).sum() for t in jax.tree.leaves(g))))
        assert clipped == pytest.approx(1.0, rel=1e-6)


# ---------------------------------------------------------- loss and grads
#: reduced configurations that keep their published GQA group (the reduced
#: config's 4 heads share 4 kv heads): granite-8b 32:8, phi4-mini-3.8b 24:8
GQA_KEPT = {"granite-8b": dict(n_heads=8, n_kv_heads=2),
            "phi4-mini-3.8b": dict(n_heads=6, n_kv_heads=2)}


def model_pair(arch: str, remat: bool, vocab: int | None = None, seed: int = 0):
    cfg_j, cfg_t = (dataclasses.replace(get(arch).reduced(), **GQA_KEPT.get(arch, {}))
                    for get in (jax_get_config, get_config))
    if vocab is not None:
        cfg_j, cfg_t = (dataclasses.replace(c, vocab=vocab) for c in (cfg_j, cfg_t))
    jm = jax_build_model(cfg_j, JaxOptions(compute_dtype="float32", remat=remat))
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(cfg_t, ModelOptions(**FP32, remat=remat), device="cpu")
    return jm, jp, tm, cfg_t


def _case(arch, remat, microbatches, vocab, param_dtype="float32", seq=16):
    name = f"{arch}-{remat}-{microbatches}-{vocab}"   # the fp32 cases keep their ids
    name += "" if seq == 16 else f"-seq{seq}"
    return pytest.param(arch, remat, microbatches, vocab, param_dtype, seq,
                        id=name if param_dtype == "float32" else f"{name}-{param_dtype}")


# leaves the port holds in fp32 whatever the weights' dtype: the norm scales,
# and the Mamba2 constants the reference reads as fp32 at every use
FP32_LEAVES = ("['norm_scale']", "['A_log']", "['D']", "['dt_bias']")


def bf16_weights(jax_params: dict, cfg) -> dict:
    """The reference's tree with its weights rounded to bf16 and held in bf16,
    the fp32 leaves fp32: the port's bf16-weight tree, converted back."""
    port = from_jax_params(jax_tree_np(jax_params), cfg, torch.bfloat16, "cpu")
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a, jnp.float32 if jax.tree_util.keystr(path).endswith(FP32_LEAVES)
                                    else jnp.bfloat16), to_jax_layout(port, cfg))


@pytest.mark.parametrize("arch,remat,microbatches,vocab,param_dtype,seq", [
    _case("minicpm-2b", False, 1, None),
    _case("minicpm-2b", True, 1, None),
    _case("minicpm-2b", False, 2, None),
    _case("minicpm-2b", True, 2, None),
    _case("minicpm-2b", True, 1, 500),    # padded vocab: the logits mask is live
    _case("glm4-9b", False, 1, None),     # GQA, untied lm_head
    _case("granite-8b", False, 1, None),  # rope_theta 1e7, untied lm_head
    _case("phi4-mini-3.8b", True, 2, None),   # untied lm_head, remat, 2 microbatches
    # bf16 weights (the port's default), fp32 compute: only the sum differs
    _case("minicpm-2b", False, 1, None, "bfloat16"),
    _case("minicpm-2b", False, 2, None, "bfloat16"),
    _case("minicpm-2b", True, 4, None, "bfloat16"),
    # the hybrid: Mamba2 layers (remat each) and the shared attention block
    _case("zamba2-2.7b", False, 1, None),
    _case("zamba2-2.7b", True, 1, None),
    _case("zamba2-2.7b", False, 2, None),
    _case("zamba2-2.7b", True, 2, None),
    _case("zamba2-2.7b", True, 1, None, seq=300),   # three chunks: dS carried, a padded tail
    _case("zamba2-2.7b", False, 1, None, "bfloat16"),
])
def test_loss_and_grads_match_the_reference(arch, remat, microbatches, vocab, param_dtype, seq):
    """fp32 weights: each gradient leaf within 1e-4 of its largest element.
    bf16 weights: the gradients are fp32 (each microbatch's bf16 gradient
    summed in fp32, as the reference sums), each leaf within 4e-4 of its norm:
    the two sides round the same fp32 gradient to bf16, and only elements that
    a last-bit difference puts across a rounding boundary differ, by one bf16
    step (summing in bf16 instead errs by 1.7e-3 of the norm at 2 microbatches
    and 2.6e-3 at 4).  The tied embedding within 4e-3: inside its microbatch
    scan the reference adds the bf16 gradients of the table's two uses in
    bf16, the port adds them in fp32 before its one rounding."""
    jm, jp, tm, cfg = model_pair(arch, remat, vocab)
    batch = SyntheticDataset(cfg.vocab, seq, 4, seed=3).batch(0)
    batch["labels"][0, :5] = -1          # masked labels are not scored
    dtype = getattr(torch, param_dtype)
    if dtype == torch.bfloat16:
        jp = bf16_weights(jp, cfg)
    jloss, jmetrics, jgrads = jax_loss_and_grads(
        jm, jp, {k: jnp.asarray(v) for k, v in batch.items()}, microbatches)
    params = from_jax_params(jax_tree_np(jp), cfg, dtype, "cpu")
    loss, metrics, grads = loss_and_grads(
        tm, params, {k: torch.from_numpy(v) for k, v in batch.items()}, microbatches)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(metrics["tokens"]) == float(jmetrics["tokens"])
    assert float(metrics["ce"]) == pytest.approx(float(jmetrics["ce"]), rel=1e-5)
    assert float(metrics["aux"]) == 0.0
    assert all(g.dtype == torch.float32 for g in jax.tree.leaves(grads))
    if dtype == torch.float32:
        assert all(p.grad is g for p, g in zip(jax.tree.leaves(params), jax.tree.leaves(grads)))
        assert_trees_close(to_jax_layout(grads, cfg), jax_tree_np(jgrads), rel=1e-4)
        return
    got, want = to_jax_layout(grads, cfg), jax_tree_np(jgrads)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)):
        name = jax.tree_util.keystr(path)
        rel = 4e-3 if name == "['embed']['tokens']" else 4e-4
        assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w), name


def test_to_jax_layout_inverts_the_converter():
    _, jp, _, cfg = model_pair("glm4-9b", False)
    want = jax_tree_np(jp)
    got = to_jax_layout(from_jax_params(want, cfg, torch.float32, "cpu"))
    assert_trees_close(got, want, rel=0.0)


# ------------------------------------------------------------------ trainer
def trainer_pair(tmp_path, total: int, fail_at=(), ckpt_every: int = 100,
                 arch: str = "minicpm-2b"):
    """The reference's trainer and the port's on the same reduced ``arch``,
    data stream and initial weights (the reference's, converted: the port's
    model draws them from its ``init``, which the test substitutes)."""
    cfg_j, cfg_t = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jm = jax_build_model(cfg_j, JaxOptions(compute_dtype="float32", remat=False))
    init = jax_tree_np(jm.init(jax.random.PRNGKey(0)))
    tm = build_model(cfg_t, ModelOptions(**FP32, remat=False), device="cpu")
    tm.init = lambda generator: from_jax_params(init, cfg_t, torch.float32, "cpu")
    tcfg = dict(total_steps=total, ckpt_every=ckpt_every, log_every=1)
    sched = dict(name="wsd", peak_lr=3e-3, warmup_steps=2, total_steps=total)
    mine = Trainer(tm, SyntheticDataset(cfg_t.vocab, 16, 4), AdamWConfig(lr=get_schedule(**sched)),
                   tmp_path / "port", TrainerConfig(**tcfg), FaultInjector(list(fail_at)))
    theirs = JaxTrainer(jm, JaxDataset(cfg_j.vocab, 16, 4), JaxAdamW(lr=jax_get_schedule(**sched)),
                        tmp_path / "ref", JaxTrainerConfig(**tcfg))
    return mine, theirs


def final_checkpoint(directory: pathlib.Path, step: int) -> dict:
    path = directory / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())["leaves"]
    return {k: np.load(path / v["file"]) for k, v in manifest.items()}


class TestTrainer:
    def test_twelve_step_loss_history_matches_the_reference(self, tmp_path):
        mine, theirs = trainer_pair(tmp_path, 12)
        mine.run()
        theirs.run()
        got, want = mine.losses(), theirs.losses()
        assert len(got) == len(want) == 12
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert got[-1] < got[0]

    def test_restart_resumes_bit_identically(self, tmp_path):
        """A crashed-and-resumed run ends with the same parameters and
        moments, bit for bit, as an uninterrupted one."""
        crashed, _ = trainer_pair(tmp_path / "a", 8, fail_at=[5], ckpt_every=4)
        crashed.run()
        assert [h for h in crashed.history if h.get("event") == "restart"]
        clean, _ = trainer_pair(tmp_path / "b", 8, ckpt_every=4)
        clean.run()
        a = final_checkpoint(tmp_path / "a" / "port", 8)
        b = final_checkpoint(tmp_path / "b" / "port", 8)
        assert a.keys() == b.keys() and "opt/step" in a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


    def test_restore_draws_no_init_and_holds_no_second_state(self, tmp_path):
        """A resume builds its restore template from fake tensors (the
        reference's ``jax.eval_shape``): ``model.init`` runs without storage
        and without drawing from its generator, so the card never holds a
        random state beside the restored one.  The resumed run still ends bit
        for bit where an uninterrupted one does (bf16 weights, the default)."""
        from torch._subclasses.fake_tensor import FakeTensor

        cfg = get_config("minicpm-2b").reduced()

        def trainer(directory, total):
            model = build_model(cfg, ModelOptions(remat=False), device="cpu")
            sched = get_schedule("wsd", peak_lr=3e-3, warmup_steps=2, total_steps=8)
            return Trainer(model, SyntheticDataset(cfg.vocab, 16, 4), AdamWConfig(lr=sched),
                           directory, TrainerConfig(total_steps=total, ckpt_every=4, log_every=1))

        trainer(tmp_path / "a", 8).run()
        trainer(tmp_path / "b", 4).run()
        resumed = trainer(tmp_path / "b", 8)
        init, restore = resumed.model.init, resumed.ckpt.restore
        drawn, templates = [], []

        def spy_init(generator):
            before = generator.get_state()   # a copy
            params = init(generator)
            drawn.append((params, before, generator.get_state()))
            return params

        def spy_restore(template, step=None):
            templates.append(template)
            return restore(template, step)

        resumed.model.init, resumed.ckpt.restore = spy_init, spy_restore
        resumed.run()
        assert len(drawn) == len(templates) == 1
        params, before, after = drawn[0]
        assert torch.equal(before, after), "the restore template consumed the init generator"
        leaves = [t for t in jax.tree.leaves(templates[0]) if isinstance(t, torch.Tensor)]
        assert leaves and all(isinstance(t, FakeTensor) for t in leaves)
        assert all(isinstance(t, FakeTensor) for t in jax.tree.leaves(params))
        assert [h["step"] for h in resumed.history] == [5, 6, 7, 8]
        a = final_checkpoint(tmp_path / "a", 8)
        b = final_checkpoint(tmp_path / "b", 8)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class TestZambaTrainer:
    """The hybrid through both trainers: remat off, fp32, reduced zamba2-2.7b."""

    def test_loss_history_matches_the_reference(self, tmp_path):
        mine, theirs = trainer_pair(tmp_path, 12, arch="zamba2-2.7b")
        mine.run()
        theirs.run()
        got, want = mine.losses(), theirs.losses()
        assert len(got) == len(want) == 12
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert got[-1] < got[0]

    def test_restart_resumes_bit_identically(self, tmp_path):
        """A crashed-and-resumed run (its restore template built under fake
        tensors by ``ZambaLM.init``) ends bit for bit where an uninterrupted
        one does."""
        crashed, _ = trainer_pair(tmp_path / "a", 8, fail_at=[5], ckpt_every=4, arch="zamba2-2.7b")
        crashed.run()
        assert [h for h in crashed.history if h.get("event") == "restart"]
        clean, _ = trainer_pair(tmp_path / "b", 8, ckpt_every=4, arch="zamba2-2.7b")
        clean.run()
        a = final_checkpoint(tmp_path / "a" / "port", 8)
        b = final_checkpoint(tmp_path / "b" / "port", 8)
        assert a.keys() == b.keys() and any("A_log" in k for k in a)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    def test_init_under_fake_tensors_draws_nothing(self):
        """``Trainer``'s restore builds its template under ``FakeTensorMode``:
        ``ZambaLM.init`` runs there without storage and leaves its generator
        untouched."""
        from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

        model = build_model(get_config("zamba2-2.7b").reduced(), ModelOptions(remat=True),
                            device="cpu")
        generator = torch.Generator().manual_seed(0)
        before = generator.get_state()
        with FakeTensorMode():
            params = model.init(generator)
        leaves = jax.tree.leaves(params)
        assert leaves and all(isinstance(t, FakeTensor) for t in leaves)
        assert torch.equal(before, generator.get_state())


# --------------------------------------------------------------- checkpoint
class TestCheckpointer:
    def tree(self):
        g = torch.Generator().manual_seed(0)
        return {"w": torch.randn(3, 4, generator=g),
                "layers": [{"b": torch.randn(5, generator=g).to(torch.bfloat16)} for _ in range(2)],
                "step": 7}

    def test_round_trip_keeps_values_dtypes_and_ints(self, tmp_path):
        ck = Checkpointer(tmp_path)
        tree = self.tree()
        ck.save(3, tree)
        template = {"w": torch.zeros(3, 4), "layers": [{"b": torch.zeros(5, dtype=torch.bfloat16)}
                                                       for _ in range(2)], "step": 0}
        out = ck.restore(template)
        assert out["step"] == 7 and isinstance(out["step"], int)
        assert torch.equal(out["w"], tree["w"])
        for a, b in zip(out["layers"], tree["layers"]):
            assert a["b"].dtype == torch.bfloat16 and torch.equal(a["b"], b["b"])

    def test_bf16_is_stored_as_the_reference_stores_it(self, tmp_path):
        """A bf16 leaf written by the port reads back through the reference's
        checkpointer (a uint16 view)."""
        Checkpointer(tmp_path).save(1, {"x": torch.tensor([1.5, -2.25, 3e-3]).to(torch.bfloat16)})
        out = JaxCheckpointer(tmp_path).restore({"x": jax.ShapeDtypeStruct((3,), jnp.bfloat16)})
        np.testing.assert_array_equal(np.asarray(out["x"]).astype(np.float32),
                                      np.array([1.5, -2.25, 3e-3], ml_dtypes.bfloat16).astype(np.float32))

    def test_snapshot_is_taken_at_save(self, tmp_path):
        ck = Checkpointer(tmp_path, use_async=True)
        w = torch.ones(1000)
        ck.save(1, {"w": w})
        w.add_(1.0)   # training goes on while the thread writes
        ck.wait()
        assert torch.equal(ck.restore({"w": torch.zeros(1000)})["w"], torch.ones(1000))

    def test_keep_last(self, tmp_path):
        ck = Checkpointer(tmp_path, keep_last=2)
        for s in (2, 4, 6, 8):
            ck.save(s, {"x": torch.full((2,), float(s))})
        assert ck.steps() == [6, 8] and ck.latest_step() == 8
        assert torch.equal(ck.restore({"x": torch.zeros(2)}, step=6)["x"], torch.full((2,), 6.0))

    def test_shape_mismatch_and_missing_raise(self, tmp_path):
        ck = Checkpointer(tmp_path)
        with pytest.raises(FileNotFoundError):
            ck.restore({"x": torch.zeros(2)})
        ck.save(1, {"x": torch.zeros(2)})
        with pytest.raises(ValueError):
            ck.restore({"x": torch.zeros(3)})
        with pytest.raises(KeyError):
            ck.restore({"y": torch.zeros(2)})


# ----------------------------------------------------------------- launcher
class TestLauncher:
    def test_cpu_run_returns_zero(self, tmp_path, capsys):
        rc = launch_train.main(["--device", "cpu", "--steps", "12", "--log-every", "4",
                                "--ckpt-every", "6", "--ckpt-dir", str(tmp_path)])
        assert rc == 0
        assert "done: first logged loss" in capsys.readouterr().out
        assert Checkpointer(tmp_path).latest_step() == 12

    def test_zamba_cpu_run_returns_zero(self, tmp_path, capsys):
        rc = launch_train.main(["--arch", "zamba2-2.7b", "--device", "cpu", "--steps", "12",
                                "--log-every", "4", "--ckpt-every", "6", "--ckpt-dir", str(tmp_path)])
        assert rc == 0
        assert "done: first logged loss" in capsys.readouterr().out
        assert Checkpointer(tmp_path).latest_step() == 12

    def test_a_finished_run_leaves_nothing_to_train(self, tmp_path, capsys):
        args = ["--device", "cpu", "--steps", "4", "--log-every", "1", "--ckpt-every", "4",
                "--ckpt-dir", str(tmp_path)]
        assert launch_train.main(args) == 0
        assert launch_train.main(args) == 0   # resumes at step 4 of 4
        assert "nothing to train: the checkpoint in" in capsys.readouterr().out

    @pytest.mark.parametrize("flag", [["--devices", "8"], ["--arnold"], ["--scheduler", "mip"]])
    def test_sharded_and_scheduled_runs_are_not_ported_yet(self, tmp_path, flag):
        """The sharded and scheduled runs are ported (tests/test_torch_parallel.py
        runs them); what the launcher still refuses, before it starts any rank,
        is a mesh larger than ``--devices``, ``--arnold`` without a mesh and
        ``--scheduler`` without ``--arnold``."""
        with pytest.raises(ValueError, match="devices"):
            launch_train.main(["--device", "cpu", "--ckpt-dir", str(tmp_path),
                               "--mesh-shape", "4x4", *flag])


@pytest.mark.parametrize("cut,unreached", [
    ("rmsnorm", 37),          # every leaf but the tied embedding lies behind the final norm
    ("flash_attention", 16),  # each layer's wq, wk, wv and the norm before them
])
def test_a_leaf_the_loss_does_not_reach_raises(cut, unreached):
    """An op whose output autograd did not record cuts the graph: the leaves
    behind it get no gradient, and ``loss_and_grads`` names them rather than
    train them on zeros."""
    from unittest import mock

    from repro_torch.kernels import ops

    op = getattr(ops, cut)
    _, _, tm, cfg = model_pair("minicpm-2b", False)
    params = tm.init(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticDataset(cfg.vocab, 16, 2).batch(0).items()}
    with mock.patch.object(ops, cut, lambda *a, **kw: op(*a, **kw).detach()):
        with pytest.raises(RuntimeError, match=re.escape("no gradient to params['layers'][0]['attn']"
                                                         f"['wq'], ") + f".* and {unreached - 3} more"):
            loss_and_grads(tm, params, batch)


def test_bf16_compute_on_fp32_masters_gives_fp32_gradients():
    """The training default: weights cast to bf16 at each use, gradients back
    in fp32 on the masters, near the fp32 run's (each leaf within 5e-2 of its
    norm: bf16 roundings along the path)."""
    _, jp, _, cfg = model_pair("minicpm-2b", True)
    master = jax_tree_np(jp)
    batch = {k: torch.from_numpy(v) for k, v in SyntheticDataset(cfg.vocab, 16, 4).batch(1).items()}
    runs = {}
    for name in ("float32", "bfloat16"):
        model = build_model(cfg, ModelOptions("float32", name, remat=True), device="cpu")
        params = from_jax_params(master, cfg, torch.float32, "cpu")
        loss, _, grads = loss_and_grads(model, params, batch)
        runs[name] = (float(loss), jax.tree.leaves(grads))
    (loss32, g32), (loss16, g16) = runs["float32"], runs["bfloat16"]
    assert loss16 == pytest.approx(loss32, rel=1e-2)
    for a, b in zip(g16, g32):
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert (a - b).norm() <= 5e-2 * b.norm()
