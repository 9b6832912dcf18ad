"""The meshed trainer's state made in its layout (``transformer.init_laid_out``,
``init_opt_state`` with shardings, ``Trainer._init_state`` under a meshed
step), in one process: rank r of a ``fake`` world of 4 on a (2, 2) ``data x
model`` mesh (no bytes move; nothing here needs a collective).

* Each rank's shard of every leaf equals its chunk of ``model.init``'s leaf of
  the same seed, bit for bit, for every family's reduced config; the layout
  draws nothing from the generator.
* An ``init`` that makes a leaf outside ``layers.made`` is refused: it would
  be laid out whole.
* At glm4-9b's published widths (40 layers, d 4096, 32/2 heads x 128, vocab
  151 552; 9.40 G parameters), traced on meta with the dry run's storage
  account (``launch.dryrun.StepCounts``): a rank's peak while the meshed
  ``_init_state`` runs is at most its shards of parameters and both moments
  plus the largest leaf (the fp32 embedding, 2.48 GB): about 30.7 GB, where
  the whole-tree init holds 112.8 GB.
"""

import contextlib

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticDataset
from repro_torch.launch import dryrun
from repro_torch.models import ModelOptions, build_model
from repro_torch.models.transformer import DecoderLM, init_laid_out, init_on_meta
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel import sharding as shd
from repro_torch.train import Trainer, make_train_step

FAMILIES = ("glm4-9b", "qwen3-moe-235b-a22b", "zamba2-2.7b", "xlstm-350m", "whisper-tiny",
            "phi-3-vision-4.2b")
OPTS = ModelOptions(param_dtype="float32", compute_dtype="bfloat16", remat=False)


@contextlib.contextmanager
def fake_rank(rank: int, size: int = 4):
    """This process as rank ``rank`` of a ``fake`` world, a (2, 2) mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=size)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _pairs(tree, prefix: str):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _pairs(v, f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _pairs(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


@pytest.mark.parametrize("arch,rank", [("glm4-9b", r) for r in range(4)]
                         + [(a, 3) for a in FAMILIES[1:]])
def test_each_shard_is_its_chunk_of_model_init(arch, rank):
    model = build_model(get_config(arch).reduced(), OPTS, device="cpu")
    whole = model.init(torch.Generator().manual_seed(7))
    with fake_rank(rank) as mesh:
        generator = torch.Generator().manual_seed(7)
        laid = init_laid_out(model, generator, lambda t: shd.param_shardings(t, mesh))
        layouts = dict(_pairs(shd.param_shardings(whole, mesh), ""))
        want = {p: shd.local_chunk(t, mesh, layouts[p].placements)
                for p, t in _pairs(whole, "")}
        got = dict(_pairs(laid, ""))
        after = torch.rand(3, generator=generator)
    assert list(got) == list(want)
    for path, leaf in got.items():
        assert shd.is_dtensor(leaf) and tuple(leaf.placements) == layouts[path].placements, path
        assert leaf.shape == dict(_pairs(whole, ""))[path].shape, path
        assert torch.equal(leaf.to_local(), want[path]), path
    # the layout drew nothing: the generator is where model.init left it
    reference = torch.Generator().manual_seed(7)
    model.init(reference)
    assert torch.equal(after, torch.rand(3, generator=reference))
    sharded = [p for p, t in got.items() if t.to_local().numel() < t.numel()]
    assert len(sharded) > len(got) // 2


class _Unmade(DecoderLM):
    @init_on_meta
    def init(self, generator):
        params = super().init(generator)
        params["extra"] = torch.zeros(4, device=self.device)   # not through layers.made
        return params


def test_a_leaf_made_outside_made_is_refused():
    model = _Unmade(get_config("glm4-9b").reduced(), OPTS, device="cpu")
    with fake_rank(0) as mesh, pytest.raises(RuntimeError, match="layers.made"):
        init_laid_out(model, torch.Generator().manual_seed(0),
                      lambda t: shd.param_shardings(t, mesh))


def test_moments_are_made_as_shards():
    model = build_model(get_config("glm4-9b").reduced(), OPTS, device="cpu")
    with fake_rank(2) as mesh:
        params = init_laid_out(model, torch.Generator().manual_seed(0),
                               lambda t: shd.param_shardings(t, mesh))
        layouts = shd.opt_shardings(params, mesh)
        state = init_opt_state(params, layouts)
        for key in ("m", "v"):
            for (path, p), (_, m), (_, s) in zip(_pairs(params, ""), _pairs(state[key], ""),
                                                 _pairs(layouts, "")):
                assert tuple(m.placements) == s.placements, path
                want = shd.local_chunk(torch.empty(p.shape, device="meta"), mesh, s.placements)
                assert m.to_local().shape == want.shape and m.shape == p.shape, path
                assert m.dtype == torch.float32 and not m.to_local().any(), path
    assert state["step"] == 0


def test_a_shard_owns_its_storage():
    """A row block of a tensor is a contiguous view; the shard is cut into a
    storage of its own, so the whole tensor can be freed.  A tensor kept
    whole is the tensor itself."""
    full = torch.arange(32.0).reshape(8, 4)
    with fake_rank(1) as mesh:   # coordinate (0, 1)
        rows = shd.local_chunk(full, mesh, shd.to_placements(("data", None), mesh))
        kept = shd.local_chunk(full, mesh, shd.to_placements((None, None), mesh))
    assert torch.equal(rows, full[:4])
    assert rows.untyped_storage().data_ptr() != full.untyped_storage().data_ptr()
    assert kept is full


def test_meshed_init_peak_at_glm4_widths(tmp_path):
    cfg = get_config("glm4-9b")
    model = build_model(cfg, ModelOptions(param_dtype="float32", compute_dtype="bfloat16",
                                          remat=True), "meta")
    n = sum(t.numel() for t in tree_leaves(model.init()))
    largest = 4 * cfg.padded_vocab * cfg.d_model
    with dryrun.fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        trainer = Trainer(model, SyntheticDataset(cfg.vocab, 1024, 8), AdamWConfig(lr=1e-4),
                          tmp_path)
        trainer.step_fn = make_train_step(model, trainer.opt_cfg, mesh=mesh)
        counts = dryrun.StepCounts()
        with counts:
            state = trainer._init_state()
        share = dryrun.local_bytes(state)
        whole = dryrun.StepCounts()
        with whole:   # the whole tree, as every rank built it before the step laid it out
            params = model.init()
            init_opt_state(params)
    assert 9.39e9 < n < 9.41e9
    assert abs(share - 3 * 4 * n / 4) < 0.001 * share          # 28.2 GB: its quarter of each
    assert share <= counts.peak_bytes <= share + largest        # <= 30.7 GB
    assert whole.peak_bytes >= 3 * 4 * n > 112e9
