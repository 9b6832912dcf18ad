"""Plain PyTorch versions of the hand-written kernels, function for function
with the reference's ``kernels/ref.py``.

These are what the CPU tests run and what each CUDA kernel is held against
on the card.  ``kernels.ops`` takes them only for a tensor that lies on the
CPU; nothing on the model's paths calls them when the tensors are on a GPU.
"""

from __future__ import annotations

import math

import torch


def _by_q_head(t: torch.Tensor, hq: int) -> torch.Tensor:
    """k or v (b, hkv, s, hd) repeated to hq heads (GQA by grouping), fp32."""
    return t.repeat_interleave(hq // t.shape[1], dim=1).float()


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """fp32 q k^T / sqrt(hd), (b, hq, sq, skv), -inf where the causal mask hides
    a key (query i sees keys j <= i + (skv - sq))."""
    sq, skv = q.shape[2], k.shape[2]
    kq = _by_q_head(k, q.shape[1])
    scores = torch.matmul(q.float(), kq.transpose(-1, -2)) / math.sqrt(q.shape[3])
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool, device=q.device).tril(skv - sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    return scores


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q: (b, hq, sq, hd); k/v: (b, hkv, skv, hd); GQA by head grouping.
    fp32 softmax, output in q.dtype."""
    probs = torch.softmax(_scores(q, k, causal), dim=-1)
    return torch.matmul(probs, _by_q_head(v, q.shape[1])).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Port-only: :func:`flash_attention_ref` and the log-sum-exp the
    backward needs.  ``lse`` is ``(b, hq, sq)`` fp32, the natural log of the sum
    of ``exp(qk^T / sqrt(hd))`` over the keys each query sees."""
    scores = _scores(q, k, causal)
    out = torch.matmul(torch.softmax(scores, dim=-1), _by_q_head(v, q.shape[1]))
    return out.to(q.dtype), torch.logsumexp(scores, dim=-1)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                            causal: bool = True, out_res: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Port-only: the analytic gradient of :func:`flash_attention_ref` with
    respect to q, k and v, given the forward's ``out`` and ``lse`` (and, for
    bf16, ``out_res``, what rounding out dropped) and the gradient ``dout`` of
    its output.  In fp32: ``P = exp(s qk^T - lse)`` (0 where masked),
    ``dV = P^T dO``, ``dP = dO V^T``, ``D = rowsum(dO * O)`` with ``O = out +
    out_res``, ``dS = P (dP - D)``, ``dQ = s dS K``, ``dK = s dS^T Q`` with s =
    1/sqrt(hd); dK and dV of a kv head are summed over its group of query
    heads.  Each gradient in its input's dtype."""
    b, hq, sq, hd = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    q32, do32 = q.float(), dout.float()
    kq = _by_q_head(k, hq)
    p = torch.exp(_scores(q, k, causal) - lse[..., None])   # exp(-inf) = 0 where masked
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, _by_q_head(v, hq).transpose(-1, -2))
    o32 = out.float() if out_res is None else out.float() + out_res.float()
    delta = (do32 * o32).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, kq) * scale
    dk = torch.matmul(ds.transpose(-1, -2), q32) * scale

    def by_kv_head(t: torch.Tensor) -> torch.Tensor:
        return t.reshape(b, hkv, group, skv, hd).sum(dim=2)

    return dq.to(q.dtype), by_kv_head(dk).to(k.dtype), by_kv_head(dv).to(v.dtype)


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., d); fp32 statistics, output in x.dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                    eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Port-only: the analytic gradient of :func:`rmsnorm_ref` with respect to
    x and scale, given the gradient ``dy`` of its output.  With ``r =
    rsqrt(mean(x^2) + eps)`` in fp32 statistics and ``g = dy * scale``:
    ``dx = r g - x r^3 mean(g x)`` in x.dtype, ``dscale = sum over rows of
    dy x r`` in fp32."""
    x32, g = x.float(), dy.float() * scale.float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    dx = r * g - x32 * (r * r * r) * (g * x32).mean(dim=-1, keepdim=True)
    dscale = (dy.float() * x32 * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale


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
    # select the exponent, then the result: above the diagonal exp(decay) may be
    # inf, and autograd through where(tri, exp(decay), 0) would give 0 * inf = NaN
    gate = torch.where(tri, torch.exp(torch.where(tri, decay, 0.0)), 0.0)
    cb = C @ B.transpose(-1, -2)                            # (..., t, u)
    w = gate * cb * dt[..., None, :]
    y_intra = w @ x                                         # (..., cs, P)
    y_state = (C @ S0.transpose(-1, -2)) * torch.exp(cum)[..., None]
    w_state = torch.exp(cum[..., -1:] - cum) * dt           # (..., cs)
    S1 = S0 * torch.exp(cum[..., -1])[..., None, None] + (x * w_state[..., None]).transpose(-1, -2) @ B
    return y_intra + y_state, S1


def ssd_chunk_bwd_ref(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dt: torch.Tensor,
                      loga: torch.Tensor, S0: torch.Tensor, dy: torch.Tensor, dS1: torch.Tensor,
                      cum_dtype: torch.dtype = torch.float64) -> tuple[torch.Tensor, ...]:
    """Port-only: the analytic gradient of :func:`ssd_chunk_ref` (same
    arguments, leading batch dims), given the gradients ``dy`` (..., cs, P) of
    y and ``dS1`` (..., P, N) of S1.  Returns (dx, dB, dC, ddt, dloga, dS0),
    all fp32.  With ``gcb = gate * (C B^T)``, ``dW = dy x^T`` and ``V = B dS1^T``:
    ``dx = (gcb dt_u)^T dy + e^{cum_L - cum_u} dt_u V``, ``dC = (dW gate dt_u) B
    + e^{cum_t} dy S0``, ``dB = (dW gate dt_u)^T C + e^{cum_L - cum_u} dt_u x
    dS1``, ``ddt`` and ``dcum`` collect the products' and the exponentials'
    derivatives, ``dloga`` is the reverse prefix sum of ``dcum`` (in
    ``cum_dtype``, rounded once) and ``dS0 = e^{cum_L} dS1 + (e^{cum_t}
    dy)^T C``."""
    cs = x.shape[-2]
    cum = torch.cumsum(loga.to(cum_dtype), dim=-1).float()
    tri = torch.ones(cs, cs, dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri, cum[..., :, None] - cum[..., None, :], 0.0)
    gate = torch.where(tri, torch.exp(decay), 0.0)          # (t, u), as ssd_chunk_ref's
    gcb = gate * (C @ B.transpose(-1, -2))
    e_cum = torch.exp(cum)                                  # (..., cs)
    e_last = torch.exp(cum[..., -1])                        # (...)
    w_state = torch.exp(cum[..., -1:] - cum) * dt           # (..., cs)
    dW = dy @ x.transpose(-1, -2)                           # (..., t, u)
    V = B @ dS1.transpose(-1, -2)                           # (..., u, p)
    dcb = dW * gate * dt[..., None, :]
    dx = (gcb * dt[..., None, :]).transpose(-1, -2) @ dy + w_state[..., None] * V
    dC = dcb @ B + e_cum[..., None] * (dy @ S0)
    dB = dcb.transpose(-1, -2) @ C + w_state[..., None] * (x @ dS1)
    r = dW * gcb
    xv = (x * V).sum(dim=-1)                                # (..., u)
    ddt = r.sum(dim=-2) + torch.exp(cum[..., -1:] - cum) * xv
    q = r * dt[..., None, :]
    h = w_state * xv
    dcum = q.sum(dim=-1) - q.sum(dim=-2) - h + e_cum * (dy * (C @ S0.transpose(-1, -2))).sum(dim=-1)
    last = h.sum(dim=-1) + e_last * (dS1 * S0).sum(dim=(-2, -1))
    dcum = torch.cat([dcum[..., :-1], dcum[..., -1:] + last[..., None]], dim=-1)
    dloga = torch.flip(torch.cumsum(torch.flip(dcum.to(cum_dtype), (-1,)), dim=-1), (-1,)).float()
    dS0 = dS1 * e_last[..., None, None] + (dy * e_cum[..., None]).transpose(-1, -2) @ C
    return dx, dB, dC, ddt, dloga, dS0


def per_head(t: torch.Tensor, H: int) -> torch.Tensor:
    """B or C as (b, H, s, N): a (b, s, N) tensor, shared by the heads, as a
    head-stride-0 view; a (b, H, s, N) tensor as it is."""
    return t[:, None].expand(-1, H, -1, -1) if t.dim() == 3 else t


def ssd_chunk_scan_ref(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dt: torch.Tensor,
                       loga: torch.Tensor, chunk: int = 128,
                       out_dtype: torch.dtype | None = None,
                       cum_dtype: torch.dtype = torch.float64) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, H, s, P); B/C: (b, H, s, N), or (b, s, N) shared by the heads;
    dt/loga: (b, H, s), s % min(chunk, s) == 0.  Every (batch, head) at once,
    chunks in order (the reference's ``ops.ssd_chunk_scan(impl="ref")``).
    Returns (y (b, H, s, P) in ``out_dtype`` or x.dtype, S_final (b, H, P, N)
    fp32).  ``cum_dtype``: see :func:`ssd_chunk_ref`."""
    b, H, s, P = x.shape
    if B.dim() == 3:
        # fp32 before the heads' view: autograd then sums shared B/C's gradient
        # over the heads in fp32 and rounds it once, as the reference's einsums do
        B, C = per_head(B.float(), H), per_head(C.float(), H)
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


def ssd_chunk_scan_bwd_ref(x: torch.Tensor, B: torch.Tensor, C: torch.Tensor, dt: torch.Tensor,
                           loga: torch.Tensor, dy: torch.Tensor,
                           dS_final: torch.Tensor | None = None, chunk: int = 128,
                           cum_dtype: torch.dtype = torch.float64) -> tuple[torch.Tensor, ...]:
    """Port-only: the analytic gradient of :func:`ssd_chunk_scan_ref` with
    respect to x, B, C, dt and loga, given the gradient ``dy`` of y and
    ``dS_final`` of S_final (None: zero).  A forward pass over the chunks
    gives each chunk's incoming state, then :func:`ssd_chunk_bwd_ref` runs the
    chunks in reverse, carrying dS.  Returns (dx in x.dtype, dB, dC in B's
    dtype and shape -- (b, s, N) B/C, shared by the heads, get the sum over
    the heads --, ddt, dloga fp32 (b, H, s))."""
    b, H, s, P = x.shape
    B4, C4 = per_head(B, H), per_head(C, H)
    N = B4.shape[-1]
    cs = min(chunk, s)
    f32 = [t.float() for t in (x, B4, C4, dt, loga, dy)]
    S = torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
    states = []
    for t0 in range(0, s, cs):
        states.append(S)
        _, S = ssd_chunk_ref(*(t[:, :, t0: t0 + cs] for t in f32[:5]), S, cum_dtype)
    dS = torch.zeros_like(S) if dS_final is None else dS_final.float()
    grads = [torch.empty_like(t) for t in f32[:5]]          # dx dB dC ddt dloga, fp32
    for c in reversed(range(len(states))):
        part = slice(c * cs, (c + 1) * cs)
        *chunk_grads, dS = ssd_chunk_bwd_ref(*(t[:, :, part] for t in f32[:5]), states[c],
                                             f32[5][:, :, part], dS, cum_dtype)
        for g, gc in zip(grads, chunk_grads):
            g[:, :, part] = gc
    dx, dB, dC, ddt, dloga = grads
    if B.dim() == 3:
        dB, dC = dB.sum(dim=1), dC.sum(dim=1)
    return dx.to(x.dtype), dB.to(B.dtype), dC.to(C.dtype), ddt, dloga
