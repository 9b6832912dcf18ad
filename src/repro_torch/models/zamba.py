"""Zamba2-style hybrid LM: Mamba2 (SSD) backbone + one *shared* attention
block applied every ``attn_every`` layers (arXiv:2411.15242).  PyTorch
counterpart of the reference's ``models/zamba.py``: training (``forward``,
``loss``), prefill forward and recurrent decode.

Mamba2 blocks use the SSD recurrence with scalar-per-head decay:
    S_t = a_t * S_{t-1} + dt_t * (x_t outer B_t),   y_t = S_t C_t + D x_t
with a short depthwise causal conv on the (x, B, C) path.  The forward runs
the chunkwise-parallel scan through ``ops.ssd_chunk_scan`` (the hand-written
CUDA kernels on a GPU, forward and backward; the reference runs the same
chunk recurrence as a ``lax.scan``), decode a single recurrent step in plain
tensor code.  The shared attention is ``layers.attention_fwd`` (the
flash-attention kernel) in the forward and a ring-buffer KV cache capped at
``cfg.long_context_window`` in decode.

As in ``models/transformer.py``: parameters and caches are explicit
dictionaries, layers a Python list (the reference stacks them
``(n_units, attn_every, ...)`` for two nested scans), caches are updated in
place and returned.  Under ``remat``, while autograd records, each Mamba2
layer runs under ``torch.utils.checkpoint`` and the shared block does not
(the reference's ``jax.checkpoint`` of ``m_body``).  ``A_log``, ``D`` and
``dt_bias`` are held in fp32 whatever the weights' dtype (the reference reads
them as fp32 at every use).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import ModelOptions, init_on_meta, resolve_device
from repro_torch.models.xlstm import _mask_padded_vocab
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import gather_at_use, lshard

CONV_K = 4  # depthwise conv window (mamba2 default)
CHUNK = 128  # SSD chunk length of the forward


# -------------------------------------------------------------- mamba2 block
def init_mamba2(generator: torch.Generator, d_model: int, d_in: int, n_heads: int,
                d_state: int, dtype: torch.dtype) -> dict:
    dev = generator.device
    conv_dim = d_in + 2 * d_state
    conv_w = torch.randn((CONV_K, conv_dim), generator=generator, device=dev) * 0.1
    return {
        "ssm": {
            # in_proj -> [z (d_in), x (d_in), B (N), C (N), dt (H)]
            "w_in": L.dense_init(generator, (d_model, 2 * d_in + 2 * d_state + n_heads), dtype=dtype),
            "conv_w": L.made(conv_w.to(dtype)),
            "A_log": L.made(torch.log(torch.linspace(1.0, float(n_heads), n_heads, device=dev))),
            "D": L.made(torch.ones(n_heads, device=dev)),
            "dt_bias": L.made(torch.log(torch.expm1(torch.full((n_heads,), 0.01, device=dev)))),
            "w_out": L.dense_init(generator, (d_in, d_model), dtype=dtype),
        },
        "norm": L.init_rmsnorm(d_model, dev),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, tail: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv.  x: (b, s, c), w: (K, c); ``tail`` (b, K-1, c)
    supplies the preceding raw inputs for streaming decode (zeros at t=0).
    The K shifted multiply-adds of the reference, in its order (a library
    convolution would run fp32 in TF32 on the card)."""
    K = w.shape[0]
    if shd.is_dtensor(x) and tail is None:
        # each rank convolves its own rows and channels; the sequence stays whole
        from torch.distributed.tensor import Replicate, Shard

        px = [p if p in (Shard(0), Shard(2)) else Replicate() for p in x.placements]
        pw = [Shard(1) if p == Shard(2) else Replicate() for p in px]
        return ops.on_shards(_causal_conv, x.device_mesh, [x, w], [px, pw], [px, px])
    if tail is None:
        full = F.pad(x, (0, 0, K - 1, 0))
    else:
        full = torch.cat([tail.to(x.dtype), x], dim=1)
    s = x.shape[1]
    out = sum(full[:, i: i + s, :] * w[i] for i in range(K))
    return out, full[:, -(K - 1):, :]


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` (b, s, ...) with ``pad`` zero positions after its sequence; a
    DTensor is padded on each rank's shard, the sequence whole."""
    if shd.is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard

        pl = [p if isinstance(p, Shard) and p.dim != 1 else Replicate() for p in t.placements]
        return ops.on_shards(lambda a: _pad_seq(a, pad), t.device_mesh, [t], [pl], [pl])
    return F.pad(t, (0,) * (2 * t.dim() - 3) + (pad,))


def _ssd_split(p: dict, x: torch.Tensor, n_heads: int, d_in: int, d_state: int,
               conv_tail: torch.Tensor | None = None):
    cd = x.dtype
    # the projection's blocks over ``model`` cut through its five parts: gathered
    proj = lshard(x @ p["w_in"].to(cd), "batch", "seq", None)
    z = proj[..., :d_in]
    xbc = proj[..., d_in: d_in + d_in + 2 * d_state]
    dt_raw = proj[..., -n_heads:]
    xbc, new_tail = _causal_conv(xbc, p["conv_w"].to(cd), conv_tail)
    xbc = F.silu(xbc.float()).to(cd)
    xc = xbc[..., :d_in]
    B = xbc[..., d_in: d_in + d_state]
    C = xbc[..., d_in + d_state:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    return z, xc, B, C, dt, new_tail


def _dims(p: dict) -> tuple[int, int, int, int]:
    """(H, d_in, d_state, P) from a Mamba2 layer's parameters."""
    H = p["A_log"].shape[0]
    d_in = p["w_out"].shape[0]
    d_state = (p["w_in"].shape[1] - 2 * d_in - H) // 2
    return H, d_in, d_state, d_in // H


def mamba2_fwd(params: dict, x: torch.Tensor, eps: float, chunk: int = CHUNK) -> torch.Tensor:
    """Chunkwise-parallel SSD over the full sequence (training, prefill).
    x: (b, s, d).  The sequence is padded to a multiple of ``chunk`` with
    dt = loga = 0, so the padding neither decays nor feeds the state; x stays
    in the model's (b, s, H, P) layout and B/C go in as (b, s, N), shared by
    the heads (so their gradient comes back summed over the heads); y comes
    back from the kernel in fp32 and stays fp32 until D x is added, as in the
    reference."""
    p = params["ssm"]
    cd = x.dtype
    b, s, _ = x.shape
    H, d_in, d_state, P = _dims(p)

    xn = L.rmsnorm(params["norm"], x, eps)
    z, xc, B, C, dt, _ = _ssd_split(p, xn, H, d_in, d_state)
    A = -torch.exp(p["A_log"].float())                       # (H,) negative
    xh = lshard(xc.reshape(b, s, H, P), "batch", "seq", "ssm_heads", None)
    loga = dt * A                                            # (b, s, H) log decay

    pad = -(-s // chunk) * chunk - s
    if pad:
        xh, B, C, dt, loga = (_pad_seq(t, pad) for t in (xh, B, C, dt, loga))
    y, _ = ops.ssd_chunk_scan(
        xh.transpose(1, 2), B, C, dt.transpose(1, 2), loga.transpose(1, 2),
        chunk=chunk, out_dtype=torch.float32,
    )                                                        # (b, H, s_pad, P) fp32
    y = y.transpose(1, 2)[:, :s] + xh[:, :s] * p["D"].float()[:, None]
    y = y.reshape(b, s, d_in).to(cd)
    y = y * F.silu(z.float()).to(cd)
    return y @ p["w_out"].to(cd)


def _ssd_step(S: torch.Tensor, xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrent SSD step, fp32: S (b, H, P, N), xh (b, H, P), dt (b, H),
    A and D (H,), B and C (b, N) -> (y (b, 1, H P), S_new).  On DTensors each
    rank steps its own lanes and heads (torch 2.11's DTensor refuses the
    batched product, which flattens the sharded heads into the batch)."""
    if shd.is_dtensor(S):
        from torch.distributed.tensor import Replicate, Shard

        pl = [p if p in (Shard(0), Shard(1)) else Replicate() for p in S.placements]
        rows = [p if p == Shard(0) else Replicate() for p in pl]
        heads = [Shard(0) if p == Shard(1) else Replicate() for p in pl]
        out = [Shard(2) if p == Shard(1) else p for p in pl]
        return ops.on_shards(_ssd_step, S.device_mesh, [S, xh, dt, A, B, C, D],
                             [pl, pl, pl, heads, rows, rows, heads], [out, pl])
    S_new = S * torch.exp(dt * A)[:, :, None, None] + (dt[:, :, None, None] * xh[..., None]) * \
        B[:, None, None, :]
    y = (S_new @ C[:, None, :, None])[..., 0]                # (b, H, P)
    y = y + xh * D[None, :, None]
    return y.reshape(y.shape[0], 1, -1), S_new


def mamba2_step(params: dict, x: torch.Tensor, S: torch.Tensor, conv_tail: torch.Tensor,
                eps: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.  x: (b, 1, d); S: (b, H, P, N) fp32;
    conv_tail: (b, CONV_K-1, conv_dim) raw pre-conv inputs of prior steps.
    Returns (out, S_new, new_tail)."""
    p = params["ssm"]
    cd = x.dtype
    b = x.shape[0]
    H, d_in, d_state, P = _dims(p)
    xn = L.rmsnorm(params["norm"], x, eps)
    z, xc, B, C, dt, conv_tail = _ssd_split(p, xn, H, d_in, d_state, conv_tail)
    A = -torch.exp(p["A_log"].float())
    y, S_new = _ssd_step(S, xc.reshape(b, H, P).float(), dt[:, 0, :], A, B[:, 0].float(),
                         C[:, 0].float(), p["D"].float())   # y (b, 1, d_in)
    y = y.to(cd) * F.silu(z.float()).to(cd)
    return y @ p["w_out"].to(cd), S_new, conv_tail


# ---------------------------------------------------------------- hybrid LM
class ZambaLM:
    """Functional hybrid LM; all state in explicit parameter / cache
    dictionaries.  A unit is ``attn_every`` Mamba2 layers followed by the one
    shared attention block, whose weights are reused at every application."""

    def __init__(self, cfg: ArchConfig, opts: ModelOptions | None = None,
                 device: torch.device | str = "cuda"):
        if cfg.family != "hybrid":
            raise ValueError(f"{cfg.name}: ZambaLM takes the hybrid family, not {cfg.family!r}")
        if cfg.n_layers % cfg.attn_every:
            raise ValueError("n_layers must be divisible by attn_every")
        self.cfg = cfg
        self.opts = opts or ModelOptions()
        self.device = resolve_device(device)
        self.n_units = cfg.n_layers // cfg.attn_every
        self.d_in = cfg.ssm_expand * cfg.d_model
        self.ssm_heads = cfg.ssm_heads or (self.d_in // 64)

    # ------------------------------------------------------------------ init
    @init_on_meta
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn on ``generator``'s device, which must be the
        model's: weights go straight to the device in ``param_dtype``.  On
        ``meta``: the tree drawn from nothing (``transformer.init_on_meta``)."""
        cfg, pdt, dev = self.cfg, self.opts.pdt, self.device
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, model on {dev}")
        return {
            "embed": {"tokens": L.dense_init(generator, (cfg.padded_vocab, cfg.d_model), dtype=pdt)},
            "layers": [init_mamba2(generator, cfg.d_model, self.d_in, self.ssm_heads,
                                   cfg.ssm_state, pdt) for _ in range(cfg.n_layers)],
            # ONE shared attention block (weights reused at every application)
            "shared": {
                "attn": L.init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                         cfg.resolved_head_dim, dtype=pdt),
                "attn_norm": L.init_rmsnorm(cfg.d_model, dev),
                "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, pdt),
                "mlp_norm": L.init_rmsnorm(cfg.d_model, dev),
            },
            "final_norm": L.init_rmsnorm(cfg.d_model, dev),
            "lm_head": L.dense_init(generator, (cfg.d_model, cfg.padded_vocab), dtype=pdt),
        }

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding: its CUDA backward sums a row's gradients in a fixed order
        x = F.embedding(tokens.long(), gather_at_use(params["embed"]["tokens"]).to(self.opts.cdt))
        return lshard(x, "batch", "seq", "embed")

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(gather_at_use(params["final_norm"]), x, self.cfg.norm_eps)
        logits = _mask_padded_vocab(x @ gather_at_use(params["lm_head"]).to(self.opts.cdt),
                                    self.cfg)
        return lshard(logits, "batch", "seq", "vocab")

    def _units(self, params: dict):
        """(unit index, that unit's Mamba2 layers with their global indices)."""
        ae = self.cfg.attn_every
        for u in range(self.n_units):
            yield u, list(enumerate(params["layers"][u * ae:(u + 1) * ae], start=u * ae))

    # --------------------------------------------------------------- forward
    def _shared_attn_fwd(self, sp: dict, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.attention_fwd(
            sp["attn"], L.rmsnorm(sp["attn_norm"], x, cfg.norm_eps), positions,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta, causal=True,
        )
        x = x + h
        return x + L.mlp_fwd(sp["mlp"], L.rmsnorm(sp["mlp_norm"], x, cfg.norm_eps))

    def _mamba_layer(self, lp: dict, x: torch.Tensor) -> torch.Tensor:
        return x + mamba2_fwd(gather_at_use(lp), x, self.cfg.norm_eps)

    def forward(self, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """batch["tokens"] (b, s) -> (logits (b, s, padded_vocab), aux: a zero
        fp32 scalar, as the reference's).  Under remat each Mamba2 layer is
        checkpointed.  The shared block's weights are gathered once, as the
        embedding's and the head's: one copy that every use and the backward
        share."""
        x = self._embed(params, batch["tokens"])
        shared = gather_at_use(params["shared"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        remat = self.opts.remat and torch.is_grad_enabled()
        for _, layers in self._units(params):
            for _, lp in layers:
                if remat:
                    # a layer draws no random numbers: no RNG state to keep
                    x = checkpoint(self._mamba_layer, lp, x, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = self._mamba_layer(lp, x)
            x = lshard(self._shared_attn_fwd(shared, x, positions), "batch", "seq", "embed")
        return self._logits(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """``layers.cross_entropy`` of the logits: (ce, {"ce", "aux",
        "tokens"}), as the reference's; the hybrid has no aux term."""
        logits, aux = self.forward(params, batch)
        ce, denom = L.cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce, "aux": aux, "tokens": denom}

    # ----------------------------------------------------------------- serve
    def kv_len(self, max_len: int) -> int:
        w = self.cfg.long_context_window
        return min(max_len, w) if w else max_len

    def init_cache(self, batch: int, max_len: int) -> dict:
        """{"S": (n_layers, b, H, P, N) fp32, "conv": (n_layers, b, CONV_K-1,
        conv_dim) fp32, "kv": {"k","v"}: (n_units, b, kv_len, K, hd),
        "kv_pos": (n_units, b, kv_len) ring positions (-1 = empty), "index"}."""
        cfg, dev = self.cfg, self.device
        P = self.d_in // self.ssm_heads
        conv_dim = self.d_in + 2 * cfg.ssm_state
        kvl = self.kv_len(max_len)
        kv = L.init_kv_cache(batch, kvl, cfg.n_kv_heads, cfg.resolved_head_dim,
                             dtype=self.opts.cdt, device=dev)
        return {
            "S": torch.zeros((cfg.n_layers, batch, self.ssm_heads, P, cfg.ssm_state),
                             dtype=torch.float32, device=dev),
            "conv": torch.zeros((cfg.n_layers, batch, CONV_K - 1, conv_dim),
                                dtype=torch.float32, device=dev),
            "kv": {n: t.new_zeros((self.n_units, *t.shape)) for n, t in kv.items()},
            "kv_pos": torch.full((self.n_units, batch, kvl), -1, dtype=torch.int32, device=dev),
            "index": 0,
        }

    def cache_axes(self) -> dict:
        """Logical axis names of every leaf of ``init_cache``'s tree: the
        Mamba2 states and conv tails on one layer axis (the reference stacks
        them on ``units, per_unit``)."""
        kv = ("units", "batch", "kv_seq", "kv_heads", "head_dim")
        return {
            "S": ("layers", "batch", "ssm_heads", None, None),
            "conv": ("layers", "batch", None, None),
            "kv": {"k": kv, "v": kv},
            "kv_pos": ("units", "batch", None),
            "index": (),
        }

    def _shared_attn_step(self, sp: dict, x: torch.Tensor, kvc: dict, kv_pos: torch.Tensor,
                          index: int) -> torch.Tensor:
        """Ring-buffer single-token shared attention; ``kvc`` and ``kv_pos``
        (this unit's slices) are updated in place."""
        cfg = self.cfg
        cd = x.dtype
        b = x.shape[0]
        hd, H, K = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
        slot = index % kvc["k"].shape[1]
        xn = L.rmsnorm(sp["attn_norm"], x, cfg.norm_eps)
        ap = sp["attn"]
        q, k_new, v_new = L._project_qkv(ap, xn, H, K, hd)
        pos = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k_new = L.apply_rope(k_new, pos, cfg.rope_theta)
        L.write_position(kvc["k"], slot, k_new[:, 0])
        L.write_position(kvc["v"], slot, v_new[:, 0])
        L.write_position(kv_pos, slot, torch.full((b,), index, dtype=kv_pos.dtype, device=x.device))
        valid = (kv_pos >= 0) & (kv_pos <= index)
        h = L.attention_scores(q, kvc["k"].to(cd), kvc["v"].to(cd), valid[:, None, None, :],
                               compute_dtype=cd).reshape(b, 1, H * hd)
        x = x + h @ ap["wo"].to(cd)
        return x + L.mlp_fwd(sp["mlp"], L.rmsnorm(sp["mlp_norm"], x, cfg.norm_eps))

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """One-token decode: tokens (b, 1) -> (logits (b, 1, padded_vocab),
        cache with ``index + 1``); the cache's tensors are updated in place."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        index = cache["index"]
        shared = gather_at_use(params["shared"])
        for u, layers in self._units(params):
            for i, lp in layers:
                y, S, tail = mamba2_step(gather_at_use(lp), x, cache["S"][i], cache["conv"][i],
                                         cfg.norm_eps)
                L.write_leading(cache["S"], (i,), S)
                L.write_leading(cache["conv"], (i,), tail)
                x = x + y
            kvc = {n: t[u] for n, t in cache["kv"].items()}
            x = self._shared_attn_step(shared, x, kvc, cache["kv_pos"][u], index)
        return self._logits(params, x), {**cache, "index": index + 1}
