"""The port's network model against the reference's: BusBw ramps, spread
and hop penalties, interference and the step-time model, through
``repro.core.netmodel`` and ``repro_torch.core.netmodel`` on the same
inputs.  Every comparison is exact (``==``); seeded draws come from two
generators made from the same seed."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as R
import repro.core.netmodel as RN
import repro.topo as RT
import repro_torch.core as P
import repro_torch.core.netmodel as PN
import repro_torch.topo as PT

NET = {R: RN, P: PN}
TOPO = {R: RT, P: PT}
SIZES = (0.0, 1 * PN.MB, 2 * PN.MB, 64 * PN.MB, 256 * PN.MB, 2 * PN.GB, 3.7e9)
SPREADS = (0, 1, 2, 3, 4, 5, 8)

# (fabric kind, constructor arguments, keyword arguments) of each family
FABRICS = {
    "clos": ("clos", ([8] * 8,), {}),
    "rail-only": ("rail-only", ([8] * 8,), {}),
    "torus": ("torus", ((2, 4),), {"nodes_per_domain": 8}),
    "torus-3d": ("torus", ((2, 2, 3),), {"nodes_per_domain": 2}),
    "dragonfly": ("dragonfly", (2,), {"routers_per_group": 4, "nodes_per_router": 8}),
}


def fabric(pkg, key):
    kind, args, kwargs = FABRICS[key]
    return TOPO[pkg].get_fabric(kind, *args, **kwargs)


def net_model(pkg, key):
    """``"legacy"``: the CLOS-calibrated base model; ``"generic"``: the
    hop-fraction base class on a clos fabric; else the fabric's own model."""
    if key == "legacy":
        return pkg.NetModel()
    if key == "generic":
        return pkg.FabricNetModel(fabric(pkg, "clos"))
    return pkg.fabric_net_model(fabric(pkg, key))


def both(fn):
    return fn(R), fn(P)


def same_config(ref, port):
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)


MODELS = ["legacy", "generic", *FABRICS]


class TestBusBw:
    @pytest.mark.parametrize("key", MODELS)
    def test_same_class_and_config(self, key):
        ref, port = both(lambda pkg: net_model(pkg, key))
        assert type(port).__name__ == type(ref).__name__
        assert getattr(port, "kind", None) == getattr(ref, "kind", None)
        same_config(ref, port)

    @pytest.mark.parametrize("key", MODELS)
    def test_collective_and_p2p_ramps(self, key):
        ref, port = both(lambda pkg: net_model(pkg, key))
        diameter = port.fabric.diameter() if hasattr(port, "fabric") else 3
        for hops in (None, *range(diameter + 2)):
            for spread in SPREADS:
                for size in SIZES:
                    assert port.collective_busbw(size, spread, hops) == \
                        ref.collective_busbw(size, spread, hops), (size, spread, hops)
                    assert port.p2p_busbw(size, spread, hops) == \
                        ref.p2p_busbw(size, spread, hops), (size, spread, hops)

    @pytest.mark.parametrize("key", MODELS)
    def test_spread_penalty(self, key):
        ref, port = both(lambda pkg: net_model(pkg, key))
        for spread in SPREADS:
            for max_deg in (0.17, 0.7, 0.3, 0.9):
                for hops in (None, 0, 1, 2, 5):
                    assert port._spread_penalty(spread, max_deg, hops) == \
                        ref._spread_penalty(spread, max_deg, hops)

    def test_saturation_and_degradation_caps(self):
        """The reference's Fig. 4a-4c checks, on the port's numbers."""
        ref, port = both(lambda pkg: pkg.NetModel())
        mb, gb = PN.MB, PN.GB
        c = [port.collective_busbw(2 * gb, s) for s in (1, 2, 3, 5)]
        p = [port.p2p_busbw(32 * mb, s) for s in (1, 2, 3, 5)]
        assert c == [ref.collective_busbw(2 * gb, s) for s in (1, 2, 3, 5)]
        assert p == [ref.p2p_busbw(32 * mb, s) for s in (1, 2, 3, 5)]
        assert c[0] > c[1] > c[2] == c[3] and p[0] > p[1] > p[2] == p[3]
        assert 1 - c[2] / c[0] == pytest.approx(0.17)
        assert 1 - p[2] / p[0] == pytest.approx(0.70)
        assert port.collective_busbw(256 * mb, 1) / port.cfg.peak_busbw > 0.8
        assert port.p2p_busbw(2 * mb, 1) / port.cfg.peak_busbw > 0.85

    @given(spread=st.integers(0, 12), size_mb=st.floats(0.0, 8192.0),
           hops=st.one_of(st.none(), st.integers(0, 6)),
           key=st.sampled_from(MODELS))
    @settings(max_examples=60, deadline=None)
    def test_property_same_bandwidth(self, spread, size_mb, hops, key):
        ref, port = net_model(R, key), net_model(P, key)
        for name in ("collective_busbw", "p2p_busbw"):
            got = getattr(port, name)(size_mb * PN.MB, spread, hops)
            assert got == getattr(ref, name)(size_mb * PN.MB, spread, hops)
            assert 0 <= got <= port.cfg.peak_busbw

    @pytest.mark.parametrize("key", MODELS)
    def test_interference_seeded(self, key):
        ref, port = both(lambda pkg: net_model(pkg, key))
        for seed in range(3):
            r_rng, p_rng = np.random.default_rng(seed), np.random.default_rng(seed)
            for s in (0, 1, 2, 3, 5, 6, 9):
                got, want = port.interference(s, p_rng), ref.interference(s, r_rng)
                assert got == want
                assert 1.0 <= got <= 1.0 + port.cfg.interference_max + 1e-9
            assert port.interference(4) == ref.interference(4)

    def test_hop_fraction(self):
        for key in FABRICS:
            ref, port = both(lambda pkg: net_model(pkg, key))
            for spread in range(0, port.fabric.n_domains + 2):
                for hops in (None, 0, 1, 3, 99):
                    assert port._hop_fraction(spread, hops) == ref._hop_fraction(spread, hops)


def comm_of(pkg, pp=8, moe=False, n_gpus=64 * 8, tp=8):
    if moe:
        m = pkg.ModelSpec(name="moe", hidden=4096, layers=32, vocab=50304, seq_len=2048,
                          global_batch=512, micro_batch=1, n_experts=16, top_k=4, d_expert=8192)
    else:
        m = pkg.ModelSpec(name="d", hidden=4096, layers=32, vocab=50304, seq_len=2048,
                          global_batch=512, micro_batch=1, d_ff=16384)
    return pkg.build_comm_matrix(pkg.JobSpec(n_gpus=n_gpus, tp=tp, pp=pp, model=m))


JOBS = {
    "dense-pp8": dict(pp=8),
    "dense-pp1": dict(pp=1),
    "moe-pp8": dict(pp=8, moe=True),
    "moe-pp2": dict(pp=2, moe=True, n_gpus=32 * 8),
    "pp-only": dict(pp=8, n_gpus=8 * 8),
}


def same_breakdown(ref, port):
    assert type(port).__name__ == "StepTimeBreakdown"
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.comm_fraction() == ref.comm_fraction()


class TestStepTime:
    @pytest.mark.parametrize("job", sorted(JOBS))
    @pytest.mark.parametrize("key", MODELS)
    def test_same_breakdown(self, job, key):
        out = []
        for pkg in (R, P):
            comm, net = comm_of(pkg, **JOBS[job]), net_model(pkg, key)
            rng = np.random.default_rng(11)
            runs = []
            for dp, pp in ((1, 1), (2, 1), (3, 3), (1, 4), (6, 2)):
                runs.append(pkg.simulate_step_time(comm, dp, pp, net=net))
                runs.append(pkg.simulate_step_time(comm, dp, pp, net=net, rng=rng))
                runs.append(pkg.simulate_step_time(comm, dp, pp, net=net, rng=rng, dp_hops=1,
                                                   pp_hops_diameter=2, mfu=0.35, overlap=0.5))
                runs.append(pkg.simulate_step_time(comm, dp, pp, net=net, dp_hops=0,
                                                   peak_flops=5e14))
            out.append(runs)
        for ref, port in zip(*out):
            same_breakdown(ref, port)

    def test_default_net_and_peak(self):
        ref, port = both(lambda pkg: pkg.simulate_step_time(comm_of(pkg), 2, 2))
        same_breakdown(ref, port)
        assert PN.H800_PEAK_FLOPS == RN.H800_PEAK_FLOPS == 990e12
        assert PN.IB_PEAK_BUSBW == RN.IB_PEAK_BUSBW

    def test_spread_slows_step_and_comm_fraction(self):
        comm = comm_of(P)
        t1 = P.simulate_step_time(comm, 1, 1).total
        t3 = P.simulate_step_time(comm, 3, 3).total
        assert t3 > t1
        assert 0.05 < P.simulate_step_time(comm, 2, 2).comm_fraction() < 0.6

    def test_pp1_and_moe_terms(self):
        assert P.simulate_step_time(comm_of(P, pp=1), 2, 1).pp_exposed == 0.0
        assert P.simulate_step_time(comm_of(P, moe=True), 1, 1).ep_exposed > 0.0
        assert P.simulate_step_time(comm_of(P), 1, 1).ep_exposed == 0.0


class TestRegistryAndConstants:
    def test_dispatch_by_kind(self):
        for key in FABRICS:
            ref, port = both(lambda pkg: pkg.fabric_net_model(fabric(pkg, key)))
            assert type(port).__name__ == type(ref).__name__
            assert type(port).__module__ == "repro_torch.core.netmodel"

    def test_unknown_kind_gets_generic_model(self):
        out = []
        for pkg in (R, P):
            class WeirdFabric(TOPO[pkg].BaseFabric):
                kind = "torch-netmodel-test-weird"

                def domain_distance(self, a, b):
                    return 0 if a == b else 1

                def diameter(self):
                    return 1

            m = pkg.fabric_net_model(WeirdFabric([2, 2]))
            assert type(m) is pkg.FabricNetModel
            out.append([m.collective_busbw(64e6, s) for s in range(4)])
        assert out[0] == out[1]

    def test_registries_are_separate(self):
        kind = "torch-netmodel-test-kind"

        class Custom(P.FabricNetModel):
            pass

        P.register_fabric_net_model(kind, Custom)
        try:
            assert PN._NET_MODELS[kind] is Custom and kind not in RN._NET_MODELS
        finally:
            del PN._NET_MODELS[kind]
        assert sorted(PN._NET_MODELS) == sorted(RN._NET_MODELS)

    def test_torus_link_constant(self):
        """The torus model's per-link bandwidth keeps the reference's value
        under the modelled fabric's name; no TPU constant is carried over."""
        assert PN.TORUS_LINK_BW == RN.TPU_ICI_BW == 50e9
        torus = fabric(P, "torus")
        assert P.TorusNetModel.default_config(torus).peak_busbw == PN.TORUS_LINK_BW
        assert not [n for n in vars(PN) if n.startswith("TPU")]

    def test_clos_model_identical_to_legacy(self):
        comm = comm_of(P, pp=2, n_gpus=96, tp=4)
        legacy, fab = P.NetModel(), P.ClosNetModel(fabric(P, "clos"))
        for spread in range(0, 9):
            for size in (1e6, 64e6, 2e9):
                assert legacy.collective_busbw(size, spread) == fab.collective_busbw(size, spread)
                assert legacy.p2p_busbw(size, spread) == fab.p2p_busbw(size, spread)
        t1 = P.simulate_step_time(comm, 2, 1, net=legacy, rng=np.random.default_rng(0))
        t2 = P.simulate_step_time(comm, 2, 1, net=fab, rng=np.random.default_rng(0))
        assert t1 == t2
