"""Workload representation: the communication matrix (paper §5.1, Eq. 1)
and the analytical communication-volume model (Appendix C, Eq. 11-13).

An LLM pre-training job (LPJ) with ``n_gpus`` accelerators and hybrid
parallelism degrees (TP, PP) is represented as a matrix of *nodes* where

    DP   = n_gpus / TP / PP          (Eq. 1)
    #row = DP / (8 / TP)             rows    -> PP groups (pipeline chains)
    #col = PP                        columns -> DP groups (replica sets)

Every matrix cell is one physical node (8 GPUs) and carries the vector
``[v_w, v_d, v_p]`` = per-GPU weight bytes, DP volume, PP volume, computed
from the analytical model; an optional ``v_e`` (expert-parallel all-to-all
volume) extends the paper's model to MoE EP traffic (DESIGN.md §4).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.topology import GPUS_PER_NODE


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """GPT-style model hyper-parameters used by the analytical volume model.

    Notation follows Appendix C / Megatron: vocabulary ``V``, global batch
    ``gb``, micro batch ``mb``, sequence length ``s``, hidden ``h``, layers
    ``l``.  MoE models add ``n_experts``/``top_k``/``d_expert`` (per-expert
    FFN hidden size); dense models leave them at 0.
    """

    name: str
    hidden: int
    layers: int
    vocab: int
    seq_len: int
    global_batch: int
    micro_batch: int = 1
    # Dense FFN hidden (0 for pure-MoE FFN stacks).
    d_ff: int = 0
    # MoE extension.
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    bytes_per_element: int = 2  # bf16 activations / grads on the wire

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """User-facing job request: #GPUs + parallelism degrees + model."""

    n_gpus: int
    tp: int
    pp: int
    model: ModelSpec
    gpu_type: str = "H800"

    def __post_init__(self):
        if self.n_gpus % (self.tp * self.pp):
            raise ValueError(
                f"n_gpus={self.n_gpus} not divisible by tp*pp={self.tp * self.pp}"
            )
        if self.n_gpus % GPUS_PER_NODE:
            raise ValueError("jobs are node-granular (8 GPUs per node)")
        if GPUS_PER_NODE % self.tp:
            raise ValueError("TP must divide the node size (TP stays intra-node, §2)")

    @property
    def dp(self) -> int:
        return self.n_gpus // self.tp // self.pp

    @property
    def n_nodes(self) -> int:
        return self.n_gpus // GPUS_PER_NODE

    @property
    def n_microbatches(self) -> int:
        m = self.model
        return max(1, m.global_batch // (m.micro_batch * self.dp))


# --------------------------------------------------------------------------
# Appendix C: analytical communication volumes (bytes per GPU per step).
# --------------------------------------------------------------------------

def dp_volume_bytes(job: JobSpec) -> float:
    """Eq. 12: DP-group volume per GPU (parameter/gradient synchronization).

    ``h*(V+s)`` covers embedding + position tables; the per-layer term
    ``4h^2+2h`` is attention (QKVO) and ``8h^2+7h`` the FFN + norms, divided
    by PP because each GPU only synchronizes its own pipeline stage.  For MoE
    models the FFN term is replaced by the expert parameters hosted per GPU
    (experts are sharded EP-wise inside the TP/"model" dimension, so the
    per-GPU share is n_experts/EP expert FFNs).
    """
    m = job.model
    emb = m.hidden * (m.vocab + m.seq_len)
    attn = 4 * m.hidden**2 + 2 * m.hidden
    if m.is_moe:
        ep = min(m.n_experts, GPUS_PER_NODE // job.tp * job.n_nodes // job.pp)
        ep = max(1, min(ep, job.dp * job.tp))  # experts sharded across the stage
        ffn = 3 * m.hidden * m.d_expert * m.n_experts / ep + 7 * m.hidden
    else:
        d_ff = m.d_ff if m.d_ff else 4 * m.hidden
        # 8h^2 + 7h with d_ff = 4h in the paper's GPT; generalize to 2*h*d_ff.
        ffn = 2 * m.hidden * d_ff + 7 * m.hidden
    elements = emb + (m.layers / job.pp) * (attn + ffn)
    return float(elements) * m.bytes_per_element


def pp_volume_bytes(job: JobSpec) -> float:
    """Eq. 13: PP-group volume per GPU per microbatch pair (fwd + bwd)."""
    m = job.model
    return float(2 * m.micro_batch * m.seq_len * m.hidden) * m.bytes_per_element


def ep_volume_bytes(job: JobSpec) -> float:
    """Beyond-paper: expert-parallel all-to-all volume per GPU per microbatch.

    Each token is routed to ``top_k`` experts: dispatch + combine moves
    ``2 * top_k * tokens * h`` elements through the all-to-all.
    """
    m = job.model
    if not m.is_moe:
        return 0.0
    tokens_per_gpu = m.micro_batch * m.seq_len
    return float(2 * m.top_k * tokens_per_gpu * m.hidden) * m.bytes_per_element


def weight_bytes_per_gpu(job: JobSpec) -> float:
    """v_w: parameter bytes hosted per GPU (stage params / TP)."""
    return dp_volume_bytes(job) / job.tp


# --------------------------------------------------------------------------
# Eq. 1: the communication matrix.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CommMatrix:
    """Node-level communication matrix for one LPJ.

    ``shape = (n_rows, n_cols)``; ``cell_volumes`` is the per-GPU
    ``[v_w, v_d, v_p]`` vector shared by all cells (groups are homogeneous,
    §5.2 "domain-specific simplification").  ``rows`` index PP groups,
    ``cols`` index DP groups.
    """

    job: JobSpec
    n_rows: int
    n_cols: int
    v_w: float
    v_d: float
    v_p: float
    v_e: float = 0.0

    @property
    def n_cells(self) -> int:
        return self.n_rows * self.n_cols

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n_rows, self.n_cols)

    def cell_ids(self) -> np.ndarray:
        """Row-major cell identifiers, shape (n_rows, n_cols)."""
        return np.arange(self.n_cells).reshape(self.n_rows, self.n_cols)

    # Fingerprint ratios used for affinity lookup (§5.2).
    def ratios(self) -> tuple[float, float]:
        m = self.job.model
        r1 = (m.micro_batch * self.v_w) / max(self.v_d + self.v_p, 1e-9)
        r2 = self.v_d / max(self.v_p, 1e-9)
        return r1, r2


def build_comm_matrix(job: JobSpec) -> CommMatrix:
    """Eq. 1 + Appendix C: derive the matrix shape and volume annotations."""
    nodes_per_pp_group_stage = GPUS_PER_NODE // job.tp  # DP replicas per node
    if job.dp % nodes_per_pp_group_stage:
        raise ValueError(
            f"DP={job.dp} must be divisible by 8/TP={nodes_per_pp_group_stage} "
            "for node-granular rows (Eq. 1)"
        )
    n_rows = job.dp // nodes_per_pp_group_stage
    n_cols = job.pp
    return CommMatrix(
        job=job,
        n_rows=n_rows,
        n_cols=n_cols,
        v_w=weight_bytes_per_gpu(job),
        v_d=dp_volume_bytes(job),
        v_p=pp_volume_bytes(job),
        v_e=ep_volume_bytes(job),
    )
