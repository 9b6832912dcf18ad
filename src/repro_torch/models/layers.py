"""Foundational layers: RMSNorm, RoPE, GQA attention (full-sequence prefill,
dense-cache decode, paged decode, paged prefill), the SwiGLU MLP and the
grouped top-k MoE.

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

import contextlib
import math
import threading

import torch

from repro_torch.kernels import ops
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import active_mesh, lshard

MASK_VALUE = -1e30


# ------------------------------------------------------------------- init
class _Making(threading.local):
    hooks: tuple = ()


_MAKING = _Making()


def made(leaf: torch.Tensor) -> torch.Tensor:
    """Every parameter a model's ``init`` makes passes through here once it is
    whole, in the order it is drawn.  Inside :func:`making` each hook, the one
    entered last first, replaces it by what it returns (``init_on_meta``'s
    meta tensor, ``transformer.init_laid_out``'s local shard), outside any
    fake-tensor mode; outside, the leaf is returned as it is."""
    if not _MAKING.hooks:
        return leaf
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        for hook in reversed(_MAKING.hooks):
            leaf = hook(leaf)
    return leaf


@contextlib.contextmanager
def making(hook):
    """Run ``hook(leaf) -> leaf`` on every leaf :func:`made` sees here."""
    prev = _MAKING.hooks
    _MAKING.hooks = prev + (hook,)
    try:
        yield
    finally:
        _MAKING.hooks = prev


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
    return made(w.to(dtype))


def init_rmsnorm(d: int, device: torch.device | str = "cpu") -> dict:
    return {"norm_scale": made(torch.ones(d, dtype=torch.float32, device=device))}


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
    if shd.is_dtensor(x):
        # a projection sharded in blocks that cut through heads is gathered first
        from torch.distributed.tensor import Replicate, Shard

        split = [i for i, p in enumerate(x.placements) if p == Shard(2)]
        if n_heads % math.prod(x.device_mesh.size(i) for i in split):
            x = x.redistribute(x.device_mesh, [Replicate() if i in split else p
                                               for i, p in enumerate(x.placements)])
    return x.reshape(b, s, n_heads, head_dim)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(b, s, h, hd) -> (b, s, h * hd).  A DTensor is reshaped on its local
    shards (batch, sequence and heads may stay sharded): where the heads are
    replicated and the gradient comes back sharded over the flat dimension in
    blocks that cut through heads, DTensor refuses to unflatten it."""
    b, s = x.shape[:2]
    if not shd.is_dtensor(x):
        return x.reshape(b, s, -1)
    from torch.distributed.tensor import Replicate, Shard

    pl = [p if isinstance(p, Shard) and p.dim in (0, 1, 2) else Replicate() for p in x.placements]
    return ops.on_shards(lambda t: t.reshape(*t.shape[:2], -1), x.device_mesh, [x], [pl], [pl])


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
    fp32, probabilities cast to ``compute_dtype`` before the PV product.
    DTensors (a meshed decode) run on their local shards: batch and heads may
    stay sharded (``ops.heads_on_shards``); ``mask`` is a plain tensor, or a
    DTensor with one row a lane (zamba's ring), taken lane by lane."""
    if shd.is_dtensor(q):
        extra = (mask,) if shd.is_dtensor(mask) else ()
        return ops.heads_on_shards(
            lambda a, b, c, *m: attention_scores(a, b, c, m[0] if m else mask, compute_dtype),
            q, k, v, 2, extra)
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


def attention_fwd(params: dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int,
                  n_kv_heads: int, head_dim: int, rope_theta: float = 1e4, causal: bool = True,
                  kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
                  use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill).  x: (b, s, d); positions: (b, s) or
    (s,); ``kv_override``: already projected (k, v), each (b, sk, K, hd), for
    cross-attention (no RoPE then, as in the reference); ``use_rope=False`` for
    absolute-position models.  The attention itself is the flash-attention
    kernel on (b, h, s, hd) views of the (b, s, h, hd) tensors; the kernel
    groups the query heads, so K/V are never repeated."""
    b, s, _ = x.shape
    cd = x.dtype
    if kv_override is None:
        q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
        if use_rope:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
    else:
        q = _split_heads(x @ params["wq"].to(cd), n_heads, head_dim)
        k, v = (t.to(cd) for t in kv_override)
    q = lshard(q, "batch", "seq", "heads", "head_dim")
    k = lshard(k, "batch", None, "kv_heads", "head_dim")
    v = lshard(v, "batch", None, "kv_heads", "head_dim")
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal
    )   # (b, H, s, hd), in q's memory layout
    out = lshard(out.transpose(1, 2), "batch", "seq", "heads", "head_dim")
    return merge_heads(out) @ params["wo"].to(cd)


# --------------------------------------------------------------- KV caching
def init_kv_cache(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16, device: torch.device | str = "cpu") -> dict:
    shape = (batch, max_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def write_position(buf: torch.Tensor, index: int, value: torch.Tensor) -> None:
    """``buf[:, index] = value`` in place; buf (b, L, ...), value (b, ...).
    On a DTensor cache each rank writes its local shard, and only the rank
    whose block of the sequence holds ``index`` when L is sharded."""
    if not shd.is_dtensor(buf):
        buf[:, index] = value.to(buf.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    start, size = shd.local_offset(buf, 1), buf.to_local().shape[1]
    pl = [p if p == Shard(0) else Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
          else Replicate() for p in buf.placements]

    def write(b, v):   # every rank lays the value out, the holder of ``index`` writes it
        if start <= index < start + size:
            write_position(b, index - start, v)

    ops.on_shards(write, buf.device_mesh, [buf, value], [buf.placements, pl], [])


def write_leading(buf: torch.Tensor, idx: tuple[int, ...], value: torch.Tensor) -> None:
    """``buf[idx] = value`` in place for integer indices ``idx`` into the
    leading (layer / unit) dimensions of a stacked cache; ``value`` has
    ``buf[idx]``'s shape.  On a DTensor cache each rank writes its local
    shard; the indexed dimensions must not be sharded (``cache_axes`` leaves
    them whole)."""
    if not shd.is_dtensor(buf):
        buf[idx] = value.to(buf.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    n = len(idx)
    if any(isinstance(p, Shard) and p.dim < n for p in buf.placements):
        raise ValueError(f"write_leading: an indexed dimension of {buf.placements} is sharded")
    pl = [Shard(p.dim - n) if isinstance(p, Shard) else Replicate() for p in buf.placements]

    def write(b, v):
        b[idx] = v.to(b.dtype)

    ops.on_shards(write, buf.device_mesh, [buf, value], [buf.placements, pl], [])


def seq_sharded_decode(n_kv_heads: int, cache_len: int) -> bool:
    """Whether decode takes the flash-decoding branch under the active mesh:
    its ``model`` size does not divide the KV heads and divides the cache
    length, so the cache is sharded on the sequence."""
    mesh = active_mesh()
    if mesh is None:
        return False
    m = shd.mesh_shape(mesh).get("model")
    return m is not None and n_kv_heads % m != 0 and cache_len % m == 0


def attention_decode(params: dict, x: torch.Tensor, cache: dict, index: int, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     rope_theta: float = 1e4, use_rope: bool = True) -> tuple[torch.Tensor, dict]:
    """Single-token decode against a dense ``(b, L, K, hd)`` cache, every lane
    at the same write position ``index``.  The cache is updated in place.
    This is the sequential oracle the paged engine is tested against.
    ``use_rope=False`` for absolute-position models (Whisper's decoder).

    Under an active mesh whose ``model`` size does not divide the KV heads
    (:func:`seq_sharded_decode`), the cache is sharded on the sequence and
    the scores stay so (partial attention per shard): attending a
    heads-sharded query would gather the whole cache every token, while the
    softmax's and the output's reductions move only (b, H) and (b, H, hd)."""
    b = x.shape[0]
    cd = x.dtype
    q, k_new, v_new = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    if use_rope:
        pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, rope_theta)
        k_new = apply_rope(k_new, pos, rope_theta)
    write_position(cache["k"], index, k_new[:, 0])
    write_position(cache["v"], index, v_new[:, 0])
    k, v = cache["k"], cache["v"]
    L = k.shape[1]
    valid = torch.arange(L, device=x.device) <= index
    if seq_sharded_decode(n_kv_heads, L):
        da = shd.data_axis_names()
        k = _repeat_kv(shd.pshard(k, da, "model", None, None).to(cd), n_heads // n_kv_heads)
        v = _repeat_kv(shd.pshard(v, da, "model", None, None).to(cd), n_heads // n_kv_heads)
        q_r = shd.pshard(q, da, None, None, None)             # replicate the query heads
        scores = torch.matmul(q_r.permute(0, 2, 1, 3).float(),
                              k.permute(0, 2, 3, 1).float()) / math.sqrt(head_dim)
        scores = torch.where(valid, scores, MASK_VALUE)
        scores = shd.pshard(scores, da, None, None, "model")  # (b, H, 1, L) seq-sharded
        probs = torch.softmax(scores, dim=-1)
        out = torch.matmul(probs.to(cd), v.permute(0, 2, 1, 3)).to(cd)
        out = shd.pshard(out.permute(0, 2, 1, 3), da, None, None, None)
    else:
        k = lshard(k, "batch", None, "kv_heads", "head_dim")
        v = lshard(v, "batch", None, "kv_heads", "head_dim")
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
    g = lshard(g, "batch", "seq", "ffn")
    act = torch.nn.functional.silu(g.float()).to(cd) * h
    return act @ params["w_out"].to(cd)


# ----------------------------------------------------------------------- MoE
def init_moe(generator: torch.Generator, d_model: int, n_experts: int, d_expert: int,
             dtype: torch.dtype = torch.float32) -> dict:
    """The router is fp32 whatever ``dtype`` is, as the reference's."""
    return {
        "router": dense_init(generator, (d_model, n_experts), dtype=torch.float32),
        "w_gate": dense_init(generator, (n_experts, d_model, d_expert), in_axis=1, dtype=dtype),
        "w_in": dense_init(generator, (n_experts, d_model, d_expert), in_axis=1, dtype=dtype),
        "w_out": dense_init(generator, (n_experts, d_expert, d_model), in_axis=1, dtype=dtype),
    }


def _fp32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in IEEE fp32 whatever the caller's TF32 setting: the router's
    logits decide the routes, and TF32 rounding flips near-ties."""
    if not (a.is_cuda and torch.backends.cuda.matmul.allow_tf32):
        return a @ b
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = True


class _GatherRows(torch.autograd.Function):
    """``out[m] = x[index[m]]`` for rows of ``x`` (n, d), with ``index[m] == n``
    reading a zero row, where ``index`` is one-to-one on the rows it reads.
    ``inverse`` (n, r) lists, for each row of ``x``, the rows of ``out`` that
    read it (``len(index)`` where fewer than r do), so the backward is a gather
    too, summing r terms in a fixed order: no atomics, the same bits on every
    call (autograd's own backward of an index is a scatter-add)."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.save_for_backward(inverse)
        return torch.cat([x, x.new_zeros(1, x.shape[1])])[index]

    @staticmethod
    def backward(ctx, dout):
        (inverse,) = ctx.saved_tensors
        padded = torch.cat([dout, dout.new_zeros(1, dout.shape[1])])
        return padded[inverse].sum(1), None, None


def moe_groups(n_tokens: int, n_experts: int, top_k: int, capacity_factor: float,
               group_size: int = 512) -> tuple[int, int]:
    """(group size, capacity per expert and group), the reference's rules:
    ``group_size`` halved until it divides the token count, and capacity
    ``max(4, ceil(top_k gs cf / E))``."""
    gs = min(group_size, n_tokens)
    while n_tokens % gs:
        gs //= 2
    return gs, max(4, math.ceil(top_k * gs / n_experts * capacity_factor))


def moe_route(logits_fp32: torch.Tensor, top_k: int, capacity: int,
              expert_idx: torch.Tensor | None = None):
    """The reference's routing for one group tensor of router logits (G, gs,
    E), fp32: (probs, renormalised gates (G, gs, k), expert_idx (G, gs, k),
    queue position (G, gs, k), keep).  Top-k by a stable descending sort, so
    that equal probabilities go to the lower expert index first, as
    ``jax.lax.top_k``; each (token, k)'s position in its expert's queue is the
    count of earlier pairs of its group in token-major, k-minor order.
    ``expert_idx``: choices made elsewhere, taken in place of the top-k (a
    comparison holding two runs to the same routes)."""
    G, gs, E = logits_fp32.shape
    probs = torch.softmax(logits_fp32, dim=-1)
    if expert_idx is None:
        expert_idx = torch.sort(probs.detach(), dim=-1, descending=True,
                                stable=True).indices[..., :top_k]
    gates = probs.gather(-1, expert_idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    onehot = torch.nn.functional.one_hot(expert_idx, E).to(torch.int32).reshape(G, gs * top_k, E)
    before = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos = before.gather(-1, expert_idx.reshape(G, gs * top_k, 1)).reshape(G, gs, top_k)
    return probs, gates, expert_idx, pos, pos < capacity


def moe_slots(expert_idx: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
              capacity: int, n_experts: int):
    """Where each kept pair goes in the (E, G, C) buffer of expert inputs:
    (slot (n, k) of each pair, E G C for a dropped one; the pair t k + kk each
    slot holds, n k for none; the token each slot reads, n for none)."""
    G, gs, top_k = expert_idx.shape
    n, slots = G * gs, n_experts * G * capacity
    group = torch.arange(G, device=pos.device)[:, None, None]
    slot = torch.where(keep, (expert_idx * G + group) * capacity + pos, slots).reshape(n, top_k)
    src_pair = torch.full((slots + 1,), n * top_k, dtype=torch.long, device=pos.device)
    src_pair[slot.reshape(-1)] = torch.arange(n * top_k, device=pos.device)   # the spare slot
    src_pair = src_pair[:slots]                                # is the only one written twice
    return slot, src_pair, torch.where(src_pair < n * top_k, src_pair // top_k, n)


def moe_dispatch(xt: torch.Tensor, src_token: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Token rows (n, d) into the slots' rows (E G C, d), zeros where a slot
    holds no pair."""
    return _GatherRows.apply(xt, src_token, slot)


def moe_experts(params: dict, xe: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts on (E, rows, d), one batched product per weight,
    the SiLU in fp32 as ``mlp_fwd``'s."""
    cd = xe.dtype
    g = torch.bmm(xe, params["w_gate"].to(cd))
    h = torch.bmm(xe, params["w_in"].to(cd))
    act = torch.nn.functional.silu(g.float()).to(cd) * h
    return torch.bmm(act, params["w_out"].to(cd))


def moe_combine(ye: torch.Tensor, slot: torch.Tensor, src_pair: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Each token's k expert outputs gathered from the slots' rows (E G C, d)
    and summed with its weights (n, k): (n, d)."""
    n, top_k = slot.shape
    yk = _GatherRows.apply(ye, slot.reshape(-1), src_pair[:, None]).reshape(n, top_k, -1)
    return torch.matmul(weights.reshape(n, 1, top_k), yk).reshape(n, -1)


def moe_fwd(params: dict, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
            group_size: int = 512, return_aux: bool = False):
    """Token-choice top-k MoE with grouped capacity, the reference's
    ``moe_fwd``: tokens blocked into groups (``moe_groups``; groups run across
    sequence boundaries), the router in fp32, pairs past their expert's
    capacity dropped, SwiGLU experts, outputs summed with the gates rounded to
    the compute dtype.  ``return_aux``: also the Switch load-balancing loss
    ``E sum(mean probs * mean top-k counts)``, the counts from the choices
    before the capacity drop.

    Dispatch and combine are by index rather than the reference's one-hot
    einsums (the same kept pairs, the same sums): kept pair (t, k) of group g
    takes slot ``(e, g, pos)`` of an (E, G, C, d) buffer, the experts are one
    batched product per weight over (E, G C, d), and each token gathers its k
    outputs back and sums them weighted by its gates in one small product.

    On DTensors (a meshed step) the routing, dispatch and combine of each
    group run on the rank that holds the group (:func:`_moe_fwd_meshed`)."""
    b, s, d = x.shape
    E = params["router"].shape[-1]
    n = b * s
    gs, capacity = moe_groups(n, E, top_k, capacity_factor, group_size)
    if active_mesh() is not None and shd.is_dtensor(x):
        return _moe_fwd_meshed(params, x, top_k, gs, capacity, return_aux)
    xt = x.reshape(n, d)
    logits = _fp32_matmul(xt.float(), params["router"]).reshape(n // gs, gs, E)
    probs, gates, expert_idx, pos, keep = moe_route(logits, top_k, capacity)
    slot, src_pair, src_token = moe_slots(expert_idx, pos, keep, capacity, E)
    xe = moe_dispatch(xt, src_token, slot).reshape(E, -1, d)
    ye = moe_experts(params, xe).reshape(-1, d)
    out = moe_combine(ye, slot, src_pair, (gates * keep).to(x.dtype)).reshape(b, s, d)
    if return_aux:
        me = probs.reshape(n, E).mean(0)
        counts = torch.nn.functional.one_hot(expert_idx.reshape(n, top_k), E).sum((0, 1))
        return out, E * torch.sum(me * (counts.float() / n))
    return out


def _moe_fwd_meshed(params: dict, x, top_k: int, gs: int, capacity: int, return_aux: bool):
    """``moe_fwd`` on DTensors, the reference's layout: the token groups
    (G, gs, d) over the data dimensions where G divides them (else every data
    rank routes all groups, as the reference's), each rank routing,
    dispatching and combining its own groups with ``moe_fwd``'s functions --
    the same routes as one device, group by group; the expert buffer (E, G, C,
    d) with the experts over ``model`` (expert parallelism: each rank runs
    its experts' SwiGLU on the slots of its groups), gathered back over
    ``model`` for the combine."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    b, s, d = x.shape
    E = params["router"].shape[-1]
    n = b * s
    G = n // gs
    mesh = x.device_mesh
    xt = lshard(x.reshape(G, gs, d), "batch", None, "embed")
    tok = list(xt.placements)                     # Shard(0) over the data dims, or Replicate
    grp = [Shard(1) if p == Shard(0) else Replicate() for p in tok]
    partial = [Partial() if p == Shard(0) else Replicate() for p in tok]
    routes = {}                                   # this rank's groups' routes, dispatch to combine

    def dispatch(xt_l, router):
        logits = _fp32_matmul(xt_l.reshape(-1, d).float(), router).reshape(-1, gs, E)
        probs, gates, expert_idx, pos, keep = moe_route(logits, top_k, capacity)
        slot, src_pair, src_token = moe_slots(expert_idx, pos, keep, capacity, E)
        routes.update(probs=probs, expert_idx=expert_idx, slot=slot, src_pair=src_pair,
                      weights=(gates * keep).to(x.dtype))
        return moe_dispatch(xt_l.reshape(-1, d), src_token, slot).reshape(E, -1, capacity, d)

    def combine(ye_l):   # every expert's slots of this rank's groups
        out = moe_combine(ye_l.reshape(-1, d), routes["slot"], routes["src_pair"],
                          routes["weights"]).reshape(-1, gs, d)
        if not return_aux:
            return out
        counts = torch.nn.functional.one_hot(routes["expert_idx"].reshape(-1, top_k), E).sum((0, 1))
        return out, routes["probs"].reshape(-1, E).sum(0), counts.float()

    xe = ops.on_shards(dispatch, mesh, [xt, params["router"]], [tok, [Replicate()] * mesh.ndim],
                       [grp])
    xe = lshard(xe, "experts", "batch", None, "embed")
    ye = moe_experts(params, xe.reshape(E, G * capacity, d)).reshape(E, G, capacity, d)
    ye = lshard(ye, "experts", "batch", None, "embed")
    if not return_aux:
        return ops.on_shards(combine, mesh, [ye], [grp], [tok]).reshape(b, s, d)
    out, me, counts = ops.on_shards(combine, mesh, [ye], [grp], [tok, partial, partial])
    me = me / n
    return out.reshape(b, s, d), E * torch.sum(me * (counts / n))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-token cross-entropy in fp32 over the (padded, masked) vocab,
    averaged over the tokens whose label is >= 0 (labels < 0 are not scored):
    (ce, the scored token count, at least 1), as the reference's losses.
    DTensor logits keep their vocab shards (:func:`_vocab_parallel_nll`)."""
    labels = labels.long()
    mask = (labels >= 0).float()
    if shd.is_dtensor(logits):
        nll = _vocab_parallel_nll(logits, labels.clamp(min=0))
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    denom = mask.sum().clamp(min=1.0)
    return (nll * mask).sum() / denom, denom


def _vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[label] of DTensor logits (b, s, V) whose vocab may
    be sharded, without gathering them: the max and the sum of exponentials
    are reduced across the vocab shards ((b, s) each), and the label's logit
    is picked with a one-hot mask each rank builds for its own block of the
    vocab (a log_softmax would gather every logit to each rank, and its
    gradient would come back whole: the LM head's weight gradient over the
    full vocab on every rank)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = logits.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate() for p in logits.placements]
    lf = logits.redistribute(mesh, pl).float()
    # each reduction over the vocab is brought to ``rows`` (the batch sharded,
    # nothing else) at once: left partial, DTensor would reduce-scatter it
    # over the vocab's mesh dimension and move the logits' gradient between
    # shards on the way back
    rows = [p if p == Shard(0) else Replicate() for p in pl]
    m = lf.amax(-1, keepdim=True).detach().redistribute(mesh, rows)
    lse = (lf - m).exp().sum(-1).redistribute(mesh, rows).log() + m[..., 0]
    start, size = shd.local_offset(lf, 2), lf.to_local().shape[-1]

    def one_hot(lab):
        return torch.arange(start, start + size, device=lab.device) == lab[..., None]

    hot = ops.on_shards(one_hot, mesh, [labels], [rows], [pl])
    return lse - (lf * hot).sum(-1).redistribute(mesh, rows)
