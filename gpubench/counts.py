"""What a training step's shapes need, counted from the configuration and the
traffic mix, and the H100's peaks (NVIDIA's data sheet, SXM part, dense:
989 TFLOP/s in bf16, 3.35 TB/s of HBM3).  Nothing here is timed.

- Model FLOPs a step: 6 N tokens + 3 x the causal attention's forward
  (4 b h s(s+1)/2 hd an application), where N counts the parameters that take
  part in matrix products: every weight but the embedding table (a lookup),
  the head with the published vocabulary, and Zamba2's shared block once for
  each of its uses.  Recomputation is not counted.
- A kernel's bound: the larger of its operations at 989 TFLOP/s and its bytes
  at 3.35 TB/s, each input read once and each output written once.
  Flash forward (bf16 q, k, v, out; fp32 lse): 4 b hq s(s+1)/2 hd operations;
  its backward 2.5 times that (reads q, k, v, out, dout, lse; writes dq, dk, dv).
"""

from __future__ import annotations

PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _bound(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def head_dim(arch: dict) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["n_heads"]


def matmul_params(arch: dict) -> int:
    """N of the model-FLOP count."""
    d, hd, H, K = arch["d_model"], head_dim(arch), arch["n_heads"], arch["n_kv_heads"]
    attn = d * H * hd + 2 * d * K * hd + H * hd * d
    mlp = 3 * d * arch["d_ff"]
    head = d * arch["vocab"]
    if arch["family"] == "dense":
        return arch["n_layers"] * (attn + mlp) + head
    d_in = arch.get("ssm_expand", 2) * d
    mamba = d * (2 * d_in + 2 * arch["ssm_state"] + arch["ssm_heads"]) + d_in * d
    uses = arch["n_layers"] // arch["attn_every"]
    return arch["n_layers"] * mamba + uses * (attn + mlp) + head


def attention_uses(arch: dict) -> int:
    return arch["n_layers"] if arch["family"] == "dense" else arch["n_layers"] // arch["attn_every"]


def attention_fwd_flops(arch: dict, batch: int, seq: int) -> int:
    """One causal application's forward."""
    return 4 * batch * arch["n_heads"] * (seq * (seq + 1) // 2) * head_dim(arch)


def model_flops(arch: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one optimizer step over ``batch`` x ``seq`` tokens."""
    return (6 * matmul_params(arch) * batch * seq
            + 3 * attention_uses(arch) * attention_fwd_flops(arch, batch, seq))


def flash_fwd_bound_s(arch: dict, batch: int, seq: int) -> float:
    hq, hk, hd = arch["n_heads"], arch["n_kv_heads"], head_dim(arch)
    nbytes = 2 * batch * seq * hd * (2 * hq + 2 * hk) + 4 * batch * hq * seq
    return _bound(attention_fwd_flops(arch, batch, seq), nbytes)


def flash_bwd_bound_s(arch: dict, batch: int, seq: int) -> float:
    hq, hk, hd = arch["n_heads"], arch["n_kv_heads"], head_dim(arch)
    nbytes = 2 * batch * seq * hd * (4 * hq + 4 * hk) + 4 * batch * hq * seq
    return _bound(2.5 * attention_fwd_flops(arch, batch, seq), nbytes)
