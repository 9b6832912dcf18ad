"""Plain PyTorch versions of the hand-written kernels, function for function
with the reference's ``kernels/ref.py``.

These are what the CPU tests run and what each CUDA kernel is held against
on the card.  ``kernels.ops`` takes them only for a tensor that lies on the
CPU; nothing on the model's paths calls them when the tensors are on a GPU.
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


def ssd_chunk_ref(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dt: torch.Tensor,
                  loga: torch.Tensor, S0: torch.Tensor,
                  cum_dtype: torch.dtype = torch.float64) -> tuple[torch.Tensor, torch.Tensor]:
    """One Mamba2 SSD chunk: x (..., cs, P), B/C (..., cs, N), dt/loga (..., cs),
    S0 (..., P, N) carried state; leading dims are batch dims (the reference
    takes a single (batch, head)).  Returns (y (..., cs, P), S1 (..., P, N)).
    All fp32 but the prefix sum of loga, taken in ``cum_dtype``."""
    cs = x.shape[-2]
    # fp64 prefix sum rounded once, as the CUDA kernel takes it: the gate
    # amplifies cum's rounding, and fp32 sums in two orders would disagree.
    # cum_dtype=float32 is the reference's own arithmetic.
    cum = torch.cumsum(loga.to(cum_dtype), dim=-1).float()  # (..., cs)
    decay = cum[..., :, None] - cum[..., None, :]           # (..., t, u)
    tri = torch.ones(cs, cs, dtype=torch.bool, device=x.device).tril()
    gate = torch.where(tri, torch.exp(decay), 0.0)          # select: exp may be inf above
    cb = C @ B.transpose(-1, -2)                            # (..., t, u)
    w = gate * cb * dt[..., None, :]
    y_intra = w @ x                                         # (..., cs, P)
    y_state = (C @ S0.transpose(-1, -2)) * torch.exp(cum)[..., None]
    w_state = torch.exp(cum[..., -1:] - cum) * dt           # (..., cs)
    S1 = S0 * torch.exp(cum[..., -1])[..., None, None] + (x * w_state[..., None]).transpose(-1, -2) @ B
    return y_intra + y_state, S1


def ssd_chunk_scan_ref(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dt: torch.Tensor,
                       loga: torch.Tensor, chunk: int = 128,
                       out_dtype: torch.dtype | None = None,
                       cum_dtype: torch.dtype = torch.float64) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, H, s, P); B/C: (b, H, s, N); dt/loga: (b, H, s), s % min(chunk, s)
    == 0.  Every (batch, head) at once, chunks in order (the reference's
    ``ops.ssd_chunk_scan(impl="ref")``).  Returns (y (b, H, s, P) in
    ``out_dtype`` or x.dtype, S_final (b, H, P, N) fp32).  ``cum_dtype``: see
    :func:`ssd_chunk_ref`."""
    b, H, s, P = x.shape
    N = B.shape[-1]
    cs = min(chunk, s)
    S = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    y = torch.empty((b, H, s, P), dtype=out_dtype or x.dtype, device=x.device)
    for t0 in range(0, s, cs):
        part = slice(t0, t0 + cs)
        y_c, S = ssd_chunk_ref(x[:, :, part].float(), B[:, :, part].float(), C[:, :, part].float(),
                               dt[:, :, part].float(), loga[:, :, part].float(), S, cum_dtype)
        y[:, :, part] = y_c
    return y, S
