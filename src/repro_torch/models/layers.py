"""Foundational layers of the serving path: RMSNorm, RoPE, GQA attention
(dense-cache decode, paged decode, paged prefill) and the SwiGLU MLP.

PyTorch counterpart of the reference's ``models/layers.py``, in the same
functional style: parameters are plain dictionaries of tensors in the
reference's layout (weights are ``(d_in, d_out)`` and applied as ``x @ W``),
every function takes them explicitly, and tensors stay on whatever device
they were given on.  RMSNorm and the prompt's causal self-attention go through
``kernels.ops`` (hand-written CUDA kernels on a GPU, plain PyTorch on the CPU).

Dtype policy: weights are used in the activations' dtype (``.to`` is free when
they are already held in it), softmax and normalisers in fp32, norm scales
fp32.

Two deliberate differences from the reference, both invisible in results:

* the paged KV pool is updated **in place** (the reference donates the buffer
  to the same effect), and carries one spare page at the end that swallows the
  writes the reference drops (``.at[slots].set(mode="drop")`` has no PyTorch
  equivalent; selecting the valid rows first would cost a host sync per layer);
* grouped-query attention against the KV cache never materialises the
  repeated K/V: :func:`attention_scores` takes K/V with fewer heads and groups
  the query heads instead.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

MASK_VALUE = -1e30


# ------------------------------------------------------------------- init
def dense_init(generator: torch.Generator, shape: tuple[int, ...], in_axis: int = 0,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal (+-2 sigma) fan-in init, drawn in fp32 on the
    generator's device and cast to ``dtype``.  Same distribution as the
    reference's; the bits differ (another generator)."""
    std = 1.0 / math.sqrt(shape[in_axis])
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    w.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    w.erfinv_().mul_(math.sqrt(2.0) * std).clamp_(-2.0 * std, 2.0 * std)
    return w.to(dtype)


def init_rmsnorm(d: int, device: torch.device | str = "cpu") -> dict:
    return {"norm_scale": torch.ones(d, dtype=torch.float32, device=device)}


def init_attention(generator: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype: torch.dtype = torch.float32) -> dict:
    return {
        "wq": dense_init(generator, (d_model, n_heads * head_dim), dtype=dtype),
        "wk": dense_init(generator, (d_model, n_kv_heads * head_dim), dtype=dtype),
        "wv": dense_init(generator, (d_model, n_kv_heads * head_dim), dtype=dtype),
        "wo": dense_init(generator, (n_heads * head_dim, d_model), dtype=dtype),
    }


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype = torch.float32) -> dict:
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), dtype=dtype),
        "w_in": dense_init(generator, (d_model, d_ff), dtype=dtype),
        "w_out": dense_init(generator, (d_ff, d_model), dtype=dtype),
    }


# ------------------------------------------------------------------- RMSNorm
def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm(x, params["norm_scale"], eps)


# ---------------------------------------------------------------------- RoPE
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> torch.Tensor:
    """(..., hd/2) rotation angles for integer positions."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exponent)
    return positions[..., None].to(torch.float32) * freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (b, s, h, hd); positions: (b, s) or (s,).  Rotates interleaved
    (even, odd) pairs, as the reference does."""
    ang = rope_angles(positions, x.shape[-1], theta)   # (b, s, hd/2) or (s, hd/2)
    if ang.dim() == 2:
        ang = ang[None]
    cos, sin = ang.cos()[:, :, None, :], ang.sin()[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    xr = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return xr.reshape(x.shape).to(x.dtype)


# ----------------------------------------------------------------- attention
def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(b, s, kv * n_rep, hd)


def attention_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                     compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """q: (b, sq, H, hd); k/v: (b, sk, Hk, hd) with Hk dividing H (q-head h
    reads kv-head h // (H / Hk); Hk == H is the reference's signature); mask
    broadcastable to (b, H, sq, sk), True = attend.  Scores and softmax in
    fp32, probabilities cast to ``compute_dtype`` before the PV product."""
    b, sq, n_heads, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    group = n_heads // n_kv
    qg = q.permute(0, 2, 1, 3).reshape(b, n_kv, group * sq, hd)
    scores = torch.matmul(qg.float(), k.permute(0, 2, 3, 1).float()) / math.sqrt(hd)
    scores = scores.reshape(b, n_heads, sq, sk)
    scores = torch.where(mask, scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(
        probs.to(compute_dtype).reshape(b, n_kv, group * sq, sk),
        v.to(compute_dtype).permute(0, 2, 1, 3),
    )
    return out.reshape(b, n_heads, sq, hd).permute(0, 2, 1, 3).to(compute_dtype)


def _project_qkv(params: dict, x: torch.Tensor, n_heads: int, n_kv_heads: int, head_dim: int):
    cd = x.dtype
    q = _split_heads(x @ params["wq"].to(cd), n_heads, head_dim)
    k = _split_heads(x @ params["wk"].to(cd), n_kv_heads, head_dim)
    v = _split_heads(x @ params["wv"].to(cd), n_kv_heads, head_dim)
    return q, k, v


# --------------------------------------------------------------- KV caching
def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cpu") -> dict:
    shape = (batch, max_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(params: dict, x: torch.Tensor, cache: dict, index: int, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     rope_theta: float = 1e4) -> tuple[torch.Tensor, dict]:
    """Single-token decode against a dense ``(b, L, K, hd)`` cache, every lane
    at the same write position ``index``.  The cache is updated in place.
    This is the sequential oracle the paged engine is tested against."""
    b = x.shape[0]
    cd = x.dtype
    q, k_new, v_new = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos, rope_theta)
    k_new = apply_rope(k_new, pos, rope_theta)
    cache["k"][:, index] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, index] = v_new[:, 0].to(cache["v"].dtype)
    k, v = cache["k"], cache["v"]
    valid = torch.arange(k.shape[1], device=x.device) <= index
    k = _repeat_kv(k.to(cd), n_heads // n_kv_heads)
    v = _repeat_kv(v.to(cd), n_heads // n_kv_heads)
    out = attention_scores(q, k, v, valid[None, None, None, :], compute_dtype=cd)
    out = out.reshape(b, 1, n_heads * head_dim)
    return out @ params["wo"].to(cd), cache


# ------------------------------------------------------- paged KV attention
#
# KV lives in fixed-size pages shared by all sequences -- {"k","v"}:
# (n_pages + 1, page_size, K, hd), the last page being the spare that takes
# dropped writes -- and each sequence owns an ordered block table of page ids.
# Logical position ``p`` of a sequence maps to physical slot
# ``table[p // ps] * ps + p % ps``.  The allocator lives in
# :mod:`repro_torch.serve.kv_cache`.


def init_paged_kv(n_pages: int, page_size: int, n_kv_heads: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cpu") -> dict:
    shape = (n_pages + 1, page_size, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _paged_scatter(pages_flat: torch.Tensor, values: torch.Tensor, slots: torch.Tensor) -> None:
    """Write ``values`` (n, K, hd) at flat slots (n,), in place.  Callers send
    writes that must be dropped (inactive lanes, padding) to the spare page."""
    pages_flat.index_copy_(0, slots, values.to(pages_flat.dtype))


def attention_decode_paged(params: dict, x: torch.Tensor, pages: dict,
                           block_table: torch.Tensor, lengths: torch.Tensor,
                           active: torch.Tensor, *, n_heads: int, n_kv_heads: int,
                           head_dim: int, rope_theta: float = 1e4
                           ) -> tuple[torch.Tensor, dict]:
    """Single-token decode against a paged KV cache.

    x: (b, 1, d), one new token per lane; block_table: (b, max_blocks) integer
    page ids, -1 = unallocated; lengths: (b,) tokens already cached per lane;
    active: (b,) bool.  Lane i writes at logical position ``lengths[i]`` and
    attends positions ``<= lengths[i]``; inactive lanes write nothing.  The
    pages are updated in place and returned.
    """
    b = x.shape[0]
    cd = x.dtype
    ps = pages["k"].shape[1]
    n_pages = pages["k"].shape[0] - 1
    max_blocks = block_table.shape[1]
    block_table = block_table.long()
    lengths = lengths.long()
    q, k_new, v_new = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    pos = lengths[:, None]
    q = apply_rope(q, pos, rope_theta)
    k_new = apply_rope(k_new, pos, rope_theta)

    write_block = block_table.gather(1, ((lengths // ps) % max_blocks)[:, None])[:, 0]
    slots = write_block * ps + lengths % ps
    slots = torch.where(active & (write_block >= 0), slots, n_pages * ps)
    flat_k = pages["k"].view(-1, n_kv_heads, head_dim)
    flat_v = pages["v"].view(-1, n_kv_heads, head_dim)
    _paged_scatter(flat_k, k_new[:, 0], slots)
    _paged_scatter(flat_v, v_new[:, 0], slots)

    # gather each lane's pages into a contiguous (L = max_blocks * ps) view
    allocated = block_table >= 0
    safe_table = torch.where(allocated, block_table, 0)
    idx = (safe_table[:, :, None] * ps + torch.arange(ps, device=x.device)).reshape(b, -1)
    k = flat_k[idx]   # (b, L, K, hd)
    v = flat_v[idx]
    kpos = torch.arange(max_blocks * ps, device=x.device)
    valid = (kpos[None, :] <= lengths[:, None]) & allocated.repeat_interleave(ps, dim=1)
    out = attention_scores(q, k.to(cd), v.to(cd), valid[:, None, None, :], compute_dtype=cd)
    out = out.reshape(b, 1, n_heads * head_dim)
    return out @ params["wo"].to(cd), pages


def attention_prefill_paged(params: dict, x: torch.Tensor, pages: dict,
                            block_table: torch.Tensor, length: int, *, n_heads: int,
                            n_kv_heads: int, head_dim: int, rope_theta: float = 1e4
                            ) -> tuple[torch.Tensor, dict]:
    """Full-prompt prefill for one sequence, scattering its KV into pages.

    x: (1, S, d), the prompt padded to a bucketed S; block_table:
    (max_blocks,) page ids, -1 = unallocated; length: true prompt length.
    Causal masking keeps padding out of positions ``< length`` and the
    padding's KV goes to the spare page, so the lane's pages hold exactly the
    ``length`` real tokens afterwards.  The s x s causal self-attention is the
    flash-attention kernel.
    """
    _, s, _ = x.shape
    cd = x.dtype
    ps = pages["k"].shape[1]
    n_pages = pages["k"].shape[0] - 1
    block_table = block_table.long()
    pos = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    q = apply_rope(q, pos[None, :], rope_theta)
    k = apply_rope(k, pos[None, :], rope_theta)

    blocks = block_table[(pos // ps) % block_table.shape[0]]
    slots = blocks * ps + pos % ps
    slots = torch.where((pos < length) & (blocks >= 0), slots, n_pages * ps)
    _paged_scatter(pages["k"].view(-1, n_kv_heads, head_dim), k[0], slots)
    _paged_scatter(pages["v"].view(-1, n_kv_heads, head_dim), v[0], slots)

    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True
    )   # (1, H, s, hd), in q's memory layout
    out = out.transpose(1, 2).reshape(1, s, n_heads * head_dim)
    return out @ params["wo"].to(cd), pages


# -------------------------------------------------------------------- SwiGLU
def mlp_fwd(params: dict, x: torch.Tensor) -> torch.Tensor:
    cd = x.dtype
    g = x @ params["w_gate"].to(cd)
    h = x @ params["w_in"].to(cd)
    act = torch.nn.functional.silu(g.float()).to(cd) * h
    return act @ params["w_out"].to(cd)
