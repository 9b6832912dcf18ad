"""The port's roofline module (``repro_torch.launch.roofline``) against the
reference's ``launch/roofline.py``: the model-FLOPs, scan-FLOPs and HBM-byte
formulas bit for bit at every (arch x shape), the ``Roofline`` record equal
to the reference's once the reference module's four TPU constants are
patched to the H100's (its file is not edited), and the collective-bytes
mode on a fake world, one collective of each kind -- the counterpart of
``tests/test_roofline.py::TestParseCollectives``."""

import dataclasses

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro.launch.roofline as ref
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import roofline as port

CELLS = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_formulas_are_the_reference_bit_for_bit(arch, shape):
    cfg, rcfg = get_config(arch), ref_config(arch)
    sh, rsh = SHAPES[shape], REF_SHAPES[shape]
    assert port.model_flops_for(cfg, sh) == ref.model_flops_for(rcfg, rsh)
    assert port.inner_scan_flops(cfg, sh) == ref.inner_scan_flops(rcfg, rsh)
    for kw in (dict(), dict(microbatches=4, attn_impl="flash", remat=False),
               dict(microbatches=2, attn_impl="xla", kv_cache_bytes=3.5e9)):
        assert port.analytic_hbm_bytes(cfg, sh, **kw) == ref.analytic_hbm_bytes(rcfg, rsh, **kw)


def test_constants_are_the_h100_datasheet_values():
    assert (port.PEAK_FLOPS, port.PEAK_FLOPS_FP32, port.HBM_BW) == (989e12, 67e12, 3.35e12)
    # NVLink 4: 18 links, 900 GB/s both ways in all
    assert port.LINKS_PER_CHIP * port.LINK_BW * 2 == 900e9


ROOFLINES = [
    dict(arch="a", shape="s", mesh="single", chips=256, hlo_flops=256 * 989e12,
         hlo_bytes=256 * 3.35e12 * 0.5, collective_bytes=256 * 18 * 25e9 * 2.0,
         collectives={}, model_flops=128 * 989e12),
    dict(arch="b", shape="t", mesh="multi", chips=512, hlo_flops=7.3e18, hlo_bytes=2.2e16,
         collective_bytes=4.1e13, collectives={"all-gather": 4.1e13}, model_flops=5.5e18,
         analytic_bytes=3.3e15),
    dict(arch="c", shape="u", mesh="single", chips=256, hlo_flops=0.0, hlo_bytes=1e12,
         collective_bytes=0.0, collectives={}, model_flops=1e9),
]


@pytest.mark.parametrize("kw", ROOFLINES, ids=lambda kw: kw["arch"])
def test_roofline_record_equals_the_reference_at_h100_constants(kw, monkeypatch):
    monkeypatch.setattr(ref, "TPU_PEAK_FLOPS", port.PEAK_FLOPS)
    monkeypatch.setattr(ref, "TPU_HBM_BW", port.HBM_BW)
    monkeypatch.setattr(ref, "TPU_ICI_LINK_BW", port.LINK_BW)
    monkeypatch.setattr(ref, "ICI_LINKS_PER_CHIP", port.LINKS_PER_CHIP)
    got, want = port.Roofline(**kw), ref.Roofline(**kw)
    assert got.to_dict() == want.to_dict()
    assert (got.bound_s, got.dominant) == (want.bound_s, want.dominant)


def test_terms_and_dominant():
    rl = port.Roofline(**ROOFLINES[0])
    assert rl.compute_s == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(0.5)
    assert rl.collective_s == pytest.approx(2.0)
    assert rl.dominant == "collective"
    assert rl.useful_ratio == pytest.approx(0.5)
    assert rl.roofline_fraction == pytest.approx(0.5)


@pytest.fixture
def world4():
    """This process as rank 0 of a fake world of 4 ranks, torn down after."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


class TestCollectiveBytes:
    def test_each_kind_counts_its_result(self, world4):
        x = torch.zeros(16, 128, dtype=torch.bfloat16)
        with port.CollectiveBytes() as mode:
            funcol.wait_tensor(funcol.all_gather_tensor(x, 0, world4))         # (64, 128)
            funcol.wait_tensor(funcol.all_reduce(torch.zeros(1024), "sum", world4))
            funcol.wait_tensor(funcol.reduce_scatter_tensor(x, "sum", 0, world4))   # (4, 128)
            out = torch.empty(8, 64, 64, dtype=torch.bfloat16)
            dist.all_to_all_single(out, torch.zeros(8, 64, 64, dtype=torch.bfloat16))
            dist.recv(torch.empty(4, 32, dtype=torch.bfloat16), src=1)
        assert mode.bytes == {
            "all-gather": 64 * 128 * 2,
            "all-reduce": 1024 * 4,
            "reduce-scatter": 4 * 128 * 2,
            "all-to-all": 8 * 64 * 64 * 2,
            "collective-permute": 4 * 32 * 2,
        }
        assert mode.elements["all-gather"] == 64 * 128
        assert set(mode.counts.values()) == {1}   # a wait is not a collective of its own

    def test_in_place_collectives_count_what_they_fill(self, world4):
        x = torch.zeros(8, 8)
        with port.CollectiveBytes() as mode:
            dist.all_reduce(x)
            dist.all_gather([torch.empty(8, 8) for _ in range(4)], x)
            dist.send(x, dst=1)   # lands on its receiver: not counted here
        assert mode.bytes == {"all-reduce": 8 * 8 * 4, "all-gather": 4 * 8 * 8 * 4}

    def test_dtensor_redistribution_is_seen_on_local_shards(self, world4):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        d = DTensor.from_local(torch.zeros(4, 6), mesh, [Shard(0), Shard(1)], run_check=False)
        with port.CollectiveBytes() as mode:
            d.redistribute(mesh, [Shard(0), Replicate()])   # gather (4, 12) over model
        assert mode.bytes == {"all-gather": 4 * 12 * 4}

    def test_non_collective_ignored(self):
        with port.CollectiveBytes() as mode:
            torch.zeros(8, 8) @ torch.zeros(8, 8)
        assert mode.bytes == {} and mode.counts == {}


def test_roofline_dataclass_fields_are_the_reference_s():
    assert [f.name for f in dataclasses.fields(port.Roofline)] == \
        [f.name for f in dataclasses.fields(ref.Roofline)]
