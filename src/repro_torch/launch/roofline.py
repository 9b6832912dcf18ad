"""Roofline analysis of a traced step on H100 constants, the counterpart of
the reference's ``launch/roofline.py``.

Three terms per (arch x shape x mesh), all in seconds:

    compute    = FLOPs / (chips * 989 TFLOP/s)
    memory     = bytes / (chips * 3.35 TB/s)
    collective = collective_bytes / (chips * 18 links * 25 GB/s)

The FLOPs, bytes and collective bytes are totals summed over chips
(``launch/dryrun.py`` counts one rank's ops and multiplies by the chips, as
the reference multiplies XLA's per-device ``cost_analysis``).  Collective
bytes come from :class:`CollectiveBytes`, a ``TorchDispatchMode`` that sums
the result-buffer bytes of every collective a step issues -- all-gather,
all-reduce, reduce-scatter, all-to-all, and a pipeline's point-to-point
receives as ``collective-permute`` -- under the reference's names for the
kinds (the reference's convention: the result's size is about the bytes
landing on each participant of a ring algorithm).  MODEL_FLOPS = 6*N*D (dense)
or 6*N_active*D (MoE) gives the useful-compute ratio that catches remat and
dispatch waste.

The collective term keeps the reference's single link class: NVLink 4, the
links of one 8-GPU node.  Across nodes a collective is bound by the NICs
(one 400 Gb/s InfiniBand NIC a GPU on a DGX H100, about 50 GB/s a direction),
not by NVLink, just as the reference leaves out the TPU's data-centre network;
a cell whose groups span nodes reads its collective term as a lower bound.

Constants are those of one H100 SXM5 from NVIDIA's H100 Tensor Core GPU
datasheet (dense, no sparsity).  ``Roofline``, :func:`inner_scan_flops`,
:func:`analytic_hbm_bytes` and :func:`model_flops_for` are the reference's, in
its order of operations (numpy-free Python floats).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989e12          # bf16 tensor cores, dense, per chip (H100 SXM5 datasheet)
PEAK_FLOPS_FP32 = 67e12      # fp32 on the CUDA cores, per chip (same datasheet)
HBM_BW = 3.35e12             # HBM3 bytes/s per chip (same datasheet)
LINK_BW = 25e9               # NVLink 4: bytes/s per link and direction (900 GB/s over 18 links, both ways)
LINKS_PER_CHIP = 18          # NVLink 4 links per H100 SXM5

#: collective op name (any of the ``_c10d_functional``, ``_c10d_functional_autograd``
#: and ``c10d`` namespaces) -> the reference's name for its kind
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "recv_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) list, tuple or dict."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def tensor_elements(tree) -> int:
    """Elements of every tensor in a (nested) list, tuple or dict."""
    return sum(t.numel() for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def collective_kind(func) -> str | None:
    """The reference's kind of a collective op, None for any other op."""
    name = getattr(func, "_schema", None)
    if name is None:
        return None
    ns, _, op = name.name.partition("::")
    return COLLECTIVE_KINDS.get(op) if ns in _NAMESPACES else None


class CollectiveBytes(TorchDispatchMode):
    """Sums the bytes of the collectives issued while it is active, by kind:
    ``.bytes`` ``{kind: bytes}``, ``.elements`` ``{kind: elements}``,
    ``.counts`` ``{kind: calls}``.  A
    functional collective counts its result (an all-gather's whole tensor, a
    reduce-scatter's shard), an in-place one (``torch.distributed``'s
    ``all_reduce``, ``all_gather``, a ``recv``) the buffers it fills; a send
    lands on its receiver, and a wait is not a collective of its own, so each
    transfer counts once.  A DTensor op is let through first
    (``NotImplemented``), so the collectives its redistributions issue are seen
    on the local tensors, as ``CommDebugMode`` sees them; ops on fake tensors
    (DTensor's shape propagation runs each op at global shapes under
    ``FakeTensorMode``) are not the step's and are not counted
    (:meth:`counted` is False for them)."""

    def __init__(self):
        super().__init__()
        self.bytes: dict[str, int] = {}
        self.elements: dict[str, int] = {}
        self.counts: dict[str, int] = {}
        self.counted = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.counted = not any(issubclass(t, FakeTensor) for t in types)
        if not self.counted:
            return out
        kind = collective_kind(func)
        if kind is not None:
            landed = out if func._schema.name.startswith("_c10d_functional") else args[0]
            self.bytes[kind] = self.bytes.get(kind, 0) + tensor_bytes(landed)
            self.elements[kind] = self.elements.get(kind, 0) + tensor_elements(landed)
            self.counts[kind] = self.counts.get(kind, 0) + 1
        return out


def inner_scan_flops(cfg, shape_spec) -> float:
    """Closed-form GLOBAL flops of recurrences that remain inside ``while``
    bodies even in the reference's unrolled analysis compile (xLSTM time
    scans, Mamba2 chunk scans), which its ``cost_analysis`` cannot see.

    Forward-only; the caller multiplies by 3 for train (bwd ~ 2x fwd).
    """
    if cfg.family not in ("ssm", "hybrid") or shape_spec.kind == "decode":
        return 0.0
    b = shape_spec.global_batch
    s = shape_spec.seq_len
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        H = cfg.n_heads
        dh = d_in // H
        n_units = cfg.n_layers // cfg.slstm_every
        n_m = n_units * (cfg.slstm_every - 1)
        n_s = n_units
        mlstm = 6.0 * b * s * n_m * H * dh * dh      # C update + C.q per step
        slstm = 8.0 * b * s * n_s * H * dh * dh      # recurrent gate matmuls
        return mlstm + slstm
    # hybrid (mamba2 chunk scan, chunk=128)
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or (d_in // 64)
    P = d_in // H
    N = cfg.ssm_state
    cs = 128
    n_chunks = max(1, s // cs)
    per_chunk = 2.0 * cs * cs * (N + P) + 4.0 * cs * P * N
    return float(b * H * n_chunks * per_chunk * cfg.n_layers)


@dataclasses.dataclass
class Roofline:
    """The reference's record.  ``hlo_flops`` / ``hlo_bytes`` keep its names:
    here the traced step's FLOPs (``FlopCounterMode``'s rules) and the bytes
    its ops read and write one op at a time (an unfused upper bound, the role
    XLA's CPU "bytes accessed" plays there), both summed over chips."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collectives: dict
    model_flops: float
    analytic_bytes: float = 0.0  # modeled true HBM traffic (global)
    compute_s: float = 0.0
    memory_s: float = 0.0
    memory_s_xla_upper: float = 0.0
    collective_s: float = 0.0

    def __post_init__(self):
        self.compute_s = self.hlo_flops / (self.chips * PEAK_FLOPS)
        self.memory_s_xla_upper = self.hlo_bytes / (self.chips * HBM_BW)
        # the per-op byte count ignores fusion and inflates HBM traffic; the
        # analytic model (analytic_hbm_bytes) is the memory term, the per-op
        # count is kept as an upper bound.  Falls back to it if no model.
        mem_bytes = self.analytic_bytes or self.hlo_bytes
        self.memory_s = mem_bytes / (self.chips * HBM_BW)
        self.collective_s = self.collective_bytes / (
            self.chips * LINKS_PER_CHIP * LINK_BW
        )

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs: fraction of the traced compute that is
        'useful' model math (catches remat/redundancy waste)."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute term / bound: 1.0 = perfectly compute-bound (at roofline),
        lower = dominated by memory or collectives."""
        return self.compute_s / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": self.collectives, "model_flops": self.model_flops,
            "analytic_bytes": self.analytic_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "memory_s_xla_upper": self.memory_s_xla_upper,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analytic_hbm_bytes(cfg, shape_spec, *, microbatches: int = 1,
                       attn_impl: str = "xla", remat: bool = True,
                       kv_cache_bytes: float = 0.0) -> float:
    """Modeled GLOBAL HBM traffic per step (bytes), summed over chips.

    Post-fusion accounting with explicit constants, the reference's:

    * weights: read once per fwd / recompute / bwd pass per microbatch
      (ZeRO-3 gathers land in HBM first), + fp32 optimizer read-modify-write;
    * activations: ~8 materialized (b, s, d) tensors per layer per pass
      (norm outs, attn in/out, mlp in/out, residuals) -- fused elementwise
      chains count once;
    * attention: "xla" materializes fp32 (b, h, s, s) scores (write + read,
      softmax in-register); "flash" (the port's kernel) keeps them on chip
      => 0 extra;
    * logits: (b, s, V) bf16 write+read (+ fp32 softmax pass in the loss);
    * decode: weights once + KV cache read + O(1) writes.

    Train multiplies fwd traffic by 3 (fwd + remat recompute + bwd) when
    remat is on, else 2.
    """
    P = cfg.param_count()
    bpe = 2  # bf16
    b = shape_spec.global_batch
    s = shape_spec.seq_len
    d = cfg.d_model

    if shape_spec.kind == "decode":
        # one token: all (active) weights stream once; KV cache streams once.
        weights = cfg.active_param_count() * bpe
        cache = kv_cache_bytes
        act = 20 * b * cfg.n_layers * d * bpe  # per-layer vectors, negligible
        return float(weights + cache + act)

    passes = 1 if shape_spec.kind == "prefill" else (3 if remat else 2)
    n_layers = cfg.n_layers + (cfg.n_encoder_layers or 0)
    weights = passes * microbatches * P * bpe
    acts = passes * 8 * n_layers * b * s * d * bpe
    attn = 0.0
    if attn_impl == "xla" and cfg.family not in ("ssm",):
        n_attn = n_layers if cfg.family != "hybrid" else max(
            1, cfg.n_layers // max(cfg.attn_every, 1))
        attn = passes * 2 * n_attn * b * cfg.n_heads * s * s * 4
    logits = 3 * b * s * cfg.vocab * bpe
    opt = 0.0
    if shape_spec.kind == "train":
        opt = 4 * P * 4  # m, v read+write in fp32 (+params RMW folded in)
    return float(weights + acts + attn + logits + opt)


def model_flops_for(cfg, shape_spec) -> float:
    """MODEL_FLOPS: 6*N*D for a train step (fwd+bwd), 2*N*D for forward-only
    prefill, 2*N_active per token for decode.  N = active params."""
    n = cfg.active_param_count()
    if shape_spec.kind == "train":
        tokens = shape_spec.global_batch * shape_spec.seq_len
        return 6.0 * n * tokens
    if shape_spec.kind == "prefill":
        tokens = shape_spec.global_batch * shape_spec.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape_spec.global_batch
