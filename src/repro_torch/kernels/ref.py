"""Plain PyTorch versions of the hand-written kernels, function for function
with the reference's ``kernels/ref.py``.

These are what the CPU tests run and what each CUDA kernel is held against
on the card.  ``kernels.ops`` takes them only for a tensor that lies on the
CPU; nothing on the serving path calls them when the tensors are on a GPU.
"""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (b, hq, sq, hd); k/v: (b, hkv, skv, hd); GQA by head grouping.
    fp32 softmax, output in q.dtype."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    kq = k.repeat_interleave(group, dim=1).float()
    vq = v.repeat_interleave(group, dim=1).float()
    scores = torch.matmul(q.float(), kq.transpose(-1, -2)) / math.sqrt(hd)
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril(skv - sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.matmul(probs, vq).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); fp32 statistics, output in x.dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
