"""Analytical network performance model calibrated to the paper's
characterization study (§4, Fig. 4; Appendix D), per-fabric since the
:mod:`repro_torch.topo` subsystem (DESIGN.md §9.3).

The paper's NCCL-test measurements are not re-run here; instead the
paper's measured behaviour is encoded as an alpha-beta
(latency-bandwidth) model with a spread-dependent degradation term:

* BusBw ramps with message size: collectives need >= ~256 MB to saturate,
  send-recv saturates at ~2 MB (Fig. 4a).
* Spanning additional minipods degrades BusBw by up to 17% for collectives
  and up to 70% for P2P send-recv (Fig. 4b/4c).
* Multi-tenant interference adds up to ~5% jitter for jobs spanning many
  minipods (Appendix D).

:class:`NetModel` keeps that CLOS calibration verbatim (its degradation is
a linear ramp in the *number* of minipods spanned, the only locality
signal a uniform-core CLOS has).  The :class:`FabricNetModel` family
generalizes the degradation term: it is derived from the fabric's hop
*distance* structure -- the hop diameter of the placement (or the
fabric's tightest-ball profile when only a spread count is known),
normalized by the fabric diameter -- with per-topology calibration
constants for ``rail-only``, ``torus`` and ``dragonfly``.
:func:`fabric_net_model` picks the right model for a fabric;
``clos`` resolves to :class:`ClosNetModel`, which reproduces
:class:`NetModel` exactly.

The port's copy of the reference's ``core/netmodel.py``: the same model,
bit for bit, in numpy.  Every constant here describes the *modelled*
cluster (the paper's H800/IB nodes, or a torus fabric's links), not a
measurement of any device this package runs on.  The registry of
per-fabric models is the port's own: a model registered here is not seen
by the reference's ``register_fabric_net_model``, nor the other way round.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.topo import Fabric

MB = 1 << 20
GB = 1 << 30

# ----------------------------------------------------------------- hardware
#: Per-link bandwidth of the modelled torus fabric (bytes/s).  50 GB/s is
#: one NVLink-4 link of an H100 (900 GB/s over 18 links).
TORUS_LINK_BW = 50e9

#: H800/IB cluster constants from the paper's environment (§2): 400 Gbps NIC
#: per GPU -> 50 GB/s inter-node per GPU; NVLink intra-node.
IB_PEAK_BUSBW = 50e9         # bytes/s, saturated inter-node BusBw per rank
H800_PEAK_FLOPS = 990e12     # fp16 dense


@dataclasses.dataclass(frozen=True)
class NetModelConfig:
    peak_busbw: float = IB_PEAK_BUSBW
    # Fig. 4a saturation points.
    collective_half_size: float = 48 * MB   # ~256MB to reach >90% of peak
    p2p_half_size: float = 0.25 * MB        # ~2MB saturates
    # Fig. 4b/4c: max degradation at max spread.
    collective_max_degradation: float = 0.17
    p2p_max_degradation: float = 0.70
    max_spread_ref: int = 3                 # spread where max degradation hits
    # Appendix D: co-tenancy interference ceiling.
    interference_max: float = 0.05


class NetModel:
    """BusBw and step-time estimates as a function of message size & spread.

    ``hops`` -- the placement's measured hop diameter
    (:func:`repro_torch.core.spread.max_hop_diameters`) -- is accepted everywhere
    for interface uniformity; this CLOS-calibrated base model ignores it
    (a uniform core has no distance gradient), the
    :class:`FabricNetModel` family uses it.
    """

    def __init__(self, cfg: NetModelConfig | None = None):
        self.cfg = cfg or NetModelConfig()

    # ------------------------------------------------------------- bandwidth
    def _size_ramp(self, size_bytes: float, half: float) -> float:
        # Saturating latency-bandwidth ramp: bw(s) = peak * s / (s + half).
        return size_bytes / (size_bytes + half)

    def _spread_penalty(
        self, spread: int, max_deg: float, hops: Optional[int] = None
    ) -> float:
        """Linear degradation in the number of *extra* minipods spanned,
        saturating at the paper's measured maximum."""
        extra = max(0, spread - 1)
        frac = min(1.0, extra / max(1, self.cfg.max_spread_ref - 1))
        return 1.0 - max_deg * frac

    def collective_busbw(
        self, size_bytes: float, spread: int, hops: Optional[int] = None
    ) -> float:
        """All-reduce / all-gather / reduce-scatter BusBw (bytes/s)."""
        c = self.cfg
        return (
            c.peak_busbw
            * self._size_ramp(size_bytes, c.collective_half_size)
            * self._spread_penalty(spread, c.collective_max_degradation, hops)
        )

    def p2p_busbw(
        self, size_bytes: float, spread: int, hops: Optional[int] = None
    ) -> float:
        """send-recv BusBw (bytes/s); much more spread-sensitive (Fig. 4c)."""
        c = self.cfg
        return (
            c.peak_busbw
            * self._size_ramp(size_bytes, c.p2p_half_size)
            * self._spread_penalty(spread, c.p2p_max_degradation, hops)
        )

    def interference(self, spread: int, rng: np.random.Generator | None = None) -> float:
        """Multiplicative slowdown from co-tenant traffic (Appendix D)."""
        frac = min(1.0, max(0, spread - 1) / 4)
        jitter = self.cfg.interference_max * frac
        if rng is None:
            return 1.0 + jitter / 2
        return 1.0 + float(rng.uniform(0.0, jitter))


# ---------------------------------------------------------------------------
# Per-fabric network models (DESIGN.md §9.3).
# ---------------------------------------------------------------------------

class FabricNetModel(NetModel):
    """Degradation derived from the fabric's hop-distance structure.

    The CLOS-only ``max_spread_ref`` linear ramp is replaced by a hop
    fraction: the group's hop diameter (measured from the placement when
    the caller has one, else the fabric's tightest ``spread``-domain ball
    via :meth:`repro_torch.topo.Fabric.distance_at_spread`) normalized by the
    fabric diameter.  Subclasses supply per-topology calibration
    constants; this generic base is used for fabrics without a bespoke
    model.
    """

    kind = "generic"

    def __init__(self, fabric: Fabric, cfg: NetModelConfig | None = None):
        super().__init__(cfg or self.default_config(fabric))
        self.fabric = fabric

    @classmethod
    def default_config(cls, fabric: Fabric) -> NetModelConfig:
        return NetModelConfig()

    def _hop_fraction(self, spread: int, hops: Optional[int] = None) -> float:
        d = hops if hops is not None else self.fabric.distance_at_spread(int(spread))
        return min(1.0, d / max(1, self.fabric.diameter()))

    def _spread_penalty(
        self, spread: int, max_deg: float, hops: Optional[int] = None
    ) -> float:
        return 1.0 - max_deg * self._hop_fraction(spread, hops)


class ClosNetModel(FabricNetModel):
    """The paper's Fig. 4 calibration on the ``clos`` fabric.

    CLOS has a uniform core, so degradation stays the legacy linear ramp
    in the number of minipods spanned -- this model is output-identical
    to :class:`NetModel`, keeping every
    pre-fabric benchmark number unchanged.
    """

    kind = "clos"

    def _spread_penalty(
        self, spread: int, max_deg: float, hops: Optional[int] = None
    ) -> float:
        return NetModel._spread_penalty(self, spread, max_deg)


class RailOnlyNetModel(FabricNetModel):
    """Rail-only fabric (arXiv:2307.12169): no core layer.

    Inside one rail group every rail is a single switch hop, so collectives
    run at near-CLOS efficiency; *crossing* rail groups has no switching
    layer and must forward through GPUs, so the penalty is a step
    function -- the hop fraction jumps straight to 1 for any multi-group
    placement -- and send-recv degradation is close to total.
    """

    kind = "rail-only"

    @classmethod
    def default_config(cls, fabric: Fabric) -> NetModelConfig:
        return NetModelConfig(
            collective_max_degradation=0.30,
            p2p_max_degradation=0.90,
        )


class TorusNetModel(FabricNetModel):
    """2D/3D torus: graded multi-hop locality (DESIGN.md §3).

    Peak BusBw is the per-link constant ``TORUS_LINK_BW``; the low-latency
    direct links saturate at much smaller messages than the IB CLOS
    (smaller half sizes), and degradation grows smoothly with the
    placement's hop diameter over the torus diameter -- multi-hop rings pay
    per-hop forwarding plus contention on shared links.
    """

    kind = "torus"

    @classmethod
    def default_config(cls, fabric: Fabric) -> NetModelConfig:
        return NetModelConfig(
            peak_busbw=TORUS_LINK_BW,
            collective_half_size=4 * MB,
            p2p_half_size=0.125 * MB,
            collective_max_degradation=0.45,
            p2p_max_degradation=0.60,
        )


class DragonflyNetModel(FabricNetModel):
    """Dragonfly (arXiv:2407.20018 §3.2): local meshes + global links.

    Spilling across routers of one group costs a direct local link
    (mild); spilling across groups routes over the shared global links
    whose contention under minimal routing is the dominant effect --
    moderate for bandwidth-optimal collectives, harsher for send-recv
    streams pinned to a single global path.
    """

    kind = "dragonfly"

    @classmethod
    def default_config(cls, fabric: Fabric) -> NetModelConfig:
        return NetModelConfig(
            collective_max_degradation=0.25,
            p2p_max_degradation=0.45,
        )


_NET_MODELS: dict[str, type[FabricNetModel]] = {}


def register_fabric_net_model(kind: str, cls: type[FabricNetModel] | None = None):
    """Associate a :class:`FabricNetModel` subclass with a fabric kind
    (usable as a decorator); :func:`fabric_net_model` dispatches on it."""

    def _register(obj):
        _NET_MODELS[kind] = obj
        return obj

    return _register if cls is None else _register(cls)


for _cls in (ClosNetModel, RailOnlyNetModel, TorusNetModel, DragonflyNetModel):
    register_fabric_net_model(_cls.kind, _cls)


def fabric_net_model(
    fabric: Fabric, cfg: NetModelConfig | None = None
) -> FabricNetModel:
    """The calibrated network model for ``fabric`` (its family's model, or
    the generic hop-fraction model for unregistered fabric kinds)."""
    cls = _NET_MODELS.get(fabric.kind, FabricNetModel)
    return cls(fabric, cfg)


@dataclasses.dataclass
class StepTimeBreakdown:
    """Per-step time decomposition of the simulated training step (s)."""

    compute: float
    dp_exposed: float
    pp_exposed: float
    ep_exposed: float
    total: float

    def comm_fraction(self) -> float:
        comm = self.dp_exposed + self.pp_exposed + self.ep_exposed
        return comm / self.total if self.total else 0.0


def simulate_step_time(
    comm,
    dp_spread: int,
    pp_spread: int,
    net: NetModel | None = None,
    peak_flops: float = H800_PEAK_FLOPS,
    mfu: float = 0.40,
    overlap: float = 0.65,
    rng: np.random.Generator | None = None,
    dp_hops: Optional[int] = None,
    pp_hops_diameter: Optional[int] = None,
) -> StepTimeBreakdown:
    """End-to-end step-time model for an LPJ under a given placement spread.

    compute:  6 * params_per_gpu * tokens_per_gpu / (peak * MFU)
    DP:       v_d / busbw(collective, dp_spread)  (once per step, partially
              overlapped with backward compute)
    PP:       per-microbatch boundary send-recv on the critical path:
              (pp - 1 + m - 1) activations forward + same backward, with
              v_p per boundary, at P2P BusBw(pp_spread)
    EP (MoE): all-to-all per microbatch at collective BusBw(max spread).

    ``overlap`` is the fraction of communication hideable under compute
    (Fig. 1a shows 30-50% of step time is *exposed* communication in
    production; the default calibrates to that range).

    ``dp_hops``/``pp_hops_diameter`` are the placement's measured hop
    diameters per axis (:func:`repro_torch.core.spread.max_hop_diameters`);
    :class:`FabricNetModel` uses them for distance-accurate degradation,
    the CLOS-calibrated base model ignores them.
    """
    net = net or NetModel()
    job = comm.job
    m = job.n_microbatches
    model = job.model

    tokens_per_gpu = model.micro_batch * model.seq_len * m
    params_per_gpu = comm.v_w / model.bytes_per_element
    compute = 6.0 * params_per_gpu * tokens_per_gpu / (peak_flops * mfu)

    dp_time = comm.v_d / net.collective_busbw(
        comm.v_d, max(1, dp_spread), hops=dp_hops
    )
    pp_hops = (job.pp - 1) + (m - 1) if job.pp > 1 else 0
    pp_time = (
        2.0 * pp_hops * comm.v_p
        / net.p2p_busbw(comm.v_p, max(1, pp_spread), hops=pp_hops_diameter)
        if job.pp > 1
        else 0.0
    )
    ep_hops = None
    if dp_hops is not None or pp_hops_diameter is not None:
        ep_hops = max(dp_hops or 0, pp_hops_diameter or 0)
    ep_time = (
        m * comm.v_e / net.collective_busbw(
            comm.v_e, max(1, max(dp_spread, pp_spread)), hops=ep_hops
        )
        if comm.v_e
        else 0.0
    )

    interference = net.interference(max(dp_spread, pp_spread), rng)
    dp_exposed = dp_time * (1 - overlap) * interference
    pp_exposed = pp_time * (1 - overlap * 0.5) * interference  # P2P overlaps worse
    ep_exposed = ep_time * (1 - overlap) * interference
    total = compute + dp_exposed + pp_exposed + ep_exposed
    return StepTimeBreakdown(
        compute=compute,
        dp_exposed=dp_exposed,
        pp_exposed=pp_exposed,
        ep_exposed=ep_exposed,
        total=total,
    )
