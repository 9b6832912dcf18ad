"""xLSTM LM: mLSTM (matrix memory) + sLSTM (scalar memory, strictly
recurrent) blocks in a repeating unit [mLSTM x (k-1), sLSTM x 1]
(arXiv:2405.04517).  PyTorch counterpart of the reference's
``models/xlstm.py``: training (``forward``, ``loss``) and recurrent decode.

The gating math is the paper's stabilised exponential form (max-stabiliser
``m_t``), both recurrences a step at a time over the sequence as the
reference's ``lax.scan``: a Python loop of small tensor ops, no kernel (the
reference has no Pallas kernel for them).  Each block's RMSNorm goes through
``ops.rmsnorm``.

As in ``models/zamba.py``: parameters and caches are explicit dictionaries, a
unit is ``{"mlstm": [m_per_unit blocks], "slstm": block}`` in a Python list of
units (the reference stacks them ``(n_units, m_per_unit, ...)``), caches are
stacked tensors updated in place and returned.  While autograd records, the
recurrences are checkpointed every ``SEG_LEN`` steps (``segmented_scan``) and,
under ``remat``, each unit as well (the reference's ``jax.checkpoint`` of the
unit body), so that the backward keeps segment boundaries, not every step's
``(b, H, dh, dh)`` matrix memory.

The head width is ``d_in // n_heads`` (512 for xlstm-350m), not
``cfg.head_dim``, as in the reference.  States are fp32 whatever the compute
dtype.

One deliberate difference, in ``init`` only: the sLSTM's per-head recurrent
weights ``r_gates`` (n_heads, dh, 4 dh) are drawn with fan-in dh.  The
reference reads the fan-in on axis 0 (n_heads = 4: std 0.5), which at
xlstm-350m's widths gives recurrent gate pre-activations of std ~10; its
forward is then chaotic (a 1e-7 perturbation moves the logits by ~4 within 8
steps) and its own ``jax.grad`` is not finite over 256 tokens.  The forward
and backward functions are the reference's; converted parameters
(``convert.from_jax_params``) are used as they are.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import ModelOptions, init_on_meta, resolve_device
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import gather_at_use, lshard

SEG_LEN = 128   # steps between the backward's saved carries (segmented_scan)


def _mask_padded_vocab(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Padding entries of the vocabulary get -1e30, so argmax / softmax
    ignore them."""
    if cfg.padded_vocab == cfg.vocab:
        return logits
    valid = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    return torch.where(valid, logits, L.MASK_VALUE)


def _scan(step, state: dict, xs: tuple, lo: int, hi: int) -> tuple[dict, torch.Tensor]:
    """Steps ``lo .. hi - 1`` of ``step(state, inputs_t) -> (state, y_t)``
    over time-major ``xs``; the outputs stacked on a leading time axis."""
    ys = []
    for t in range(lo, hi):
        state, y = step(state, tuple(x[t] for x in xs))
        ys.append(y)
    return state, torch.stack(ys)


def segmented_scan(step, state: dict, xs: tuple, seg_len: int = SEG_LEN
                   ) -> tuple[dict, torch.Tensor]:
    """The reference's ``segmented_scan``: while autograd records and the
    sequence is several whole segments long, each ``seg_len``-step segment
    runs under ``torch.utils.checkpoint``, so the backward keeps only the
    carries at segment boundaries and recomputes a segment at a time;
    otherwise a plain scan.  Numerically the same either way."""
    s = xs[0].shape[0]
    if not torch.is_grad_enabled() or seg_len >= s or s % seg_len:
        return _scan(step, state, xs, 0, s)
    ys = []
    for lo in range(0, s, seg_len):
        # a segment draws no random numbers: no RNG state to keep
        state, y = checkpoint(_scan, step, state, xs, lo, lo + seg_len, use_reentrant=False,
                              preserve_rng_state=False)
        ys.append(y)
    return state, torch.cat(ys)


def recurrence(step, weights: tuple, state: dict, xs: tuple) -> tuple[dict, torch.Tensor]:
    """``segmented_scan`` of ``step(weights, state, inputs_t)`` over the
    time-major ``xs`` (each (s, b, H, ...) or (s, b, H x width)) from ``state``
    (leaves (b, H, ...)); ``weights``: tensors with a leading head dimension.
    On DTensors each rank scans its own lanes and heads, the layout of the
    first DTensor among the state's leaves and ``xs`` (torch 2.11's DTensor
    refuses the steps' batched products, which flatten the sharded heads into
    the batch)."""
    def scan(w, st, x):
        return segmented_scan(lambda st_, inp: step(w, st_, inp), st, x)

    lead = next((t for t in (*state.values(), *xs) if shd.is_dtensor(t)), None)
    if lead is None:
        return scan(weights, state, xs)
    from torch.distributed.tensor import Replicate, Shard

    batch = 0 if any(lead is t for t in state.values()) else 1   # lead's batch dimension
    kinds = ["batch" if p == Shard(batch) else "heads" if p == Shard(batch + 1) else None
             for p in lead.placements]

    def pl(batch_dim, heads_dim):
        return [Shard(batch_dim) if k == "batch" and batch_dim is not None
                else Shard(heads_dim) if k == "heads" else Replicate() for k in kinds]

    keys, n = list(state), len(xs)

    def local(*args):   # xs first: a replicated weight's gradient is then a partial sum
        st, hs = scan(args[n + len(keys):], dict(zip(keys, args[n:n + len(keys)])), args[:n])
        return (*(st[k] for k in keys), hs)

    out = ops.on_shards(local, lead.device_mesh, [*xs, *(state[k] for k in keys), *weights],
                        [pl(1, 2)] * n + [pl(0, 1)] * len(keys) + [pl(None, 0)] * len(weights),
                        [pl(0, 1)] * len(keys) + [pl(1, 2)])
    return dict(zip(keys, out[:-1])), out[-1]


# ---------------------------------------------------------------- mLSTM cell
def init_mlstm(generator: torch.Generator, d_model: int, d_in: int, n_heads: int,
               dtype: torch.dtype) -> dict:
    dev = generator.device
    return {
        "ssm": {
            "w_in": L.dense_init(generator, (d_model, 2 * d_in), dtype=dtype),   # x branch + gate z
            "w_q": L.dense_init(generator, (d_in, d_in), dtype=dtype),
            "w_k": L.dense_init(generator, (d_in, d_in), dtype=dtype),
            "w_v": L.dense_init(generator, (d_in, d_in), dtype=dtype),
            "w_i": L.dense_init(generator, (d_in, n_heads), dtype=dtype),
            "w_f": L.dense_init(generator, (d_in, n_heads), dtype=dtype),
            "w_out": L.dense_init(generator, (d_in, d_model), dtype=dtype),
            "f_bias": L.made(torch.full((n_heads,), 3.0, dtype=dtype, device=dev)),   # open forget gates
        },
        "norm": L.init_rmsnorm(d_model, dev),
    }


def mlstm_state(batch: int, n_heads: int, dh: int, device: torch.device | str = "cpu") -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, n_heads, dh, dh), **f32),
            "n": torch.zeros((batch, n_heads, dh), **f32),
            "m": torch.full((batch, n_heads), -1e30, **f32)}


def _mlstm_step(state: dict, qkv_ifg: tuple) -> tuple[dict, torch.Tensor]:
    """One stabilised mLSTM step.  q, k, v: (b, H, dh); i, f: (b, H) raw
    logits; all fp32."""
    q, k, v, i_raw, f_raw = qkv_ifg
    C, n, m = state["C"], state["n"], state["m"]
    logf = F.logsigmoid(f_raw)                         # sigmoid forget gate
    m_new = torch.maximum(logf + m, i_raw)
    i_p = torch.exp(i_raw - m_new)
    f_p = torch.exp(logf + m - m_new)
    C_new = f_p[..., None, None] * C + i_p[..., None, None] * (
        v[..., :, None] * k[..., None, :])             # (b, H, dh, dh): v outer k
    n_new = f_p[..., None] * n + i_p[..., None] * k
    denom = torch.maximum((n_new * q).sum(-1).abs(), torch.exp(-m_new))
    h = (C_new @ q[..., None])[..., 0] / denom[..., None]
    return {"C": C_new, "n": n_new, "m": m_new}, h


def mlstm_fwd(params: dict, x: torch.Tensor, state: dict, eps: float
              ) -> tuple[torch.Tensor, dict]:
    """x: (b, s, d) -> (y, new state); the recurrence over time."""
    p = params["ssm"]
    cd = x.dtype
    b, s, _ = x.shape
    H = p["w_i"].shape[-1]
    xn = L.rmsnorm(params["norm"], x, eps)
    xm, z = (xn @ p["w_in"].to(cd)).chunk(2, dim=-1)
    d_in = xm.shape[-1]
    dh = d_in // H
    q = (xm @ p["w_q"].to(cd)).reshape(b, s, H, dh)
    k = (xm @ p["w_k"].to(cd)).reshape(b, s, H, dh) / math.sqrt(dh)
    v = (xm @ p["w_v"].to(cd)).reshape(b, s, H, dh)
    q, k, v = (lshard(t, "batch", "seq", "heads", None) for t in (q, k, v))
    i_raw = (xm @ p["w_i"].to(cd)).float()
    f_raw = (xm @ p["w_f"].to(cd)).float() + p["f_bias"].float()
    xs = tuple(t.transpose(0, 1).float() for t in (q, k, v, i_raw, f_raw))   # time-major
    state, hs = recurrence(lambda w, st, inp: _mlstm_step(st, inp), (), state, xs)   # (s, b, H, dh)
    h = L.merge_heads(hs.transpose(0, 1)).to(cd)
    h = h * F.silu(z.float()).to(cd)
    return h @ p["w_out"].to(cd), state


# ---------------------------------------------------------------- sLSTM cell
def init_slstm(generator: torch.Generator, d_model: int, d_in: int, n_heads: int,
               dtype: torch.dtype) -> dict:
    dev = generator.device
    dh = d_in // n_heads
    return {
        "ssm": {
            "w_in": L.dense_init(generator, (d_model, d_in), dtype=dtype),
            "w_gates": L.dense_init(generator, (d_in, 4 * d_in), dtype=dtype),         # i, f, z, o
            # per head, fan-in dh (see the module note: not the reference's n_heads)
            "r_gates": L.dense_init(generator, (n_heads, dh, 4 * dh), in_axis=1, dtype=dtype),
            "w_out": L.dense_init(generator, (d_in, d_model), dtype=dtype),
            "f_bias": L.made(torch.full((d_in,), 3.0, dtype=dtype, device=dev)),
        },
        "norm": L.init_rmsnorm(d_model, dev),
    }


def slstm_state(batch: int, n_heads: int, dh: int, device: torch.device | str = "cpu") -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, n_heads, dh), **f32),
            "n": torch.ones((batch, n_heads, dh), **f32),
            "m": torch.zeros((batch, n_heads, dh), **f32),
            "h": torch.zeros((batch, n_heads, dh), **f32)}


def _slstm_step(p: dict, state: dict, xg: torch.Tensor, H: int, dh: int) -> dict:
    """xg: (b, 4 d_in) pre-activation gates from the input path; each head's
    block of 4 dh splits into i, f, z, o."""
    c, n, m, h_prev = state["c"], state["n"], state["m"], state["h"]
    b = xg.shape[0]
    rec = torch.einsum("bhd,hdg->bhg", h_prev, p["r_gates"].to(h_prev.dtype))
    gates = xg.reshape(b, H, 4 * dh) + rec             # promotes to fp32
    i_raw, f_raw, z_raw, o_raw = gates.float().chunk(4, dim=-1)
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i_p = torch.exp(i_raw - m_new)
    f_p = torch.exp(logf + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(z_raw)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def slstm_bias(p: dict, cd: torch.dtype) -> torch.Tensor:
    """The (4 d_in,) bias on the input path's gates, in the compute dtype: the
    reference writes ``f_bias`` at ``[d_in, 2 d_in)`` of the flat gate axis,
    which the step's per-head split reads as head 1's whole i, f, z, o block
    (the reference's placement, kept)."""
    d_in = p["f_bias"].shape[0]
    pad = lambda f: F.pad(f.to(cd), (d_in, 2 * d_in))   # noqa: E731
    if shd.is_dtensor(p["f_bias"]):
        # padded on each rank's copy: torch 2.11's DTensor pads a replicated
        # tensor into one that a partial sum then counts once per rank
        from torch.distributed.tensor import Replicate

        f = p["f_bias"]
        whole = [Replicate()] * f.device_mesh.ndim
        return ops.on_shards(pad, f.device_mesh, [f], [whole], [whole])
    return pad(p["f_bias"])


def slstm_fwd(params: dict, x: torch.Tensor, state: dict, eps: float
              ) -> tuple[torch.Tensor, dict]:
    p = params["ssm"]
    cd = x.dtype
    dh = p["r_gates"].shape[1]
    xn = L.rmsnorm(params["norm"], x, eps)
    xg = (xn @ p["w_in"].to(cd)) @ p["w_gates"].to(cd) + slstm_bias(p, cd)

    def step(w, st, inp):   # w: (r_gates,), this rank's heads of it
        st = _slstm_step({"r_gates": w[0]}, st, inp[0], w[0].shape[0], dh)
        return st, st["h"]

    state, hs = recurrence(step, (p["r_gates"],), state, (xg.transpose(0, 1),))
    h = L.merge_heads(hs.transpose(0, 1)).to(cd)
    return h @ p["w_out"].to(cd), state


# ------------------------------------------------------------------ full LM
class XLSTMLM:
    """Repeating unit of (slstm_every - 1) mLSTM blocks + 1 sLSTM block."""

    def __init__(self, cfg: ArchConfig, opts: ModelOptions | None = None,
                 device: torch.device | str = "cuda"):
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.name}: XLSTMLM takes the ssm family, not {cfg.family!r}")
        if cfg.n_layers % cfg.slstm_every:
            raise ValueError("n_layers must be divisible by slstm_every")
        self.cfg = cfg
        self.opts = opts or ModelOptions()
        self.device = resolve_device(device)
        self.n_units = cfg.n_layers // cfg.slstm_every
        self.m_per_unit = cfg.slstm_every - 1
        self.d_in = cfg.ssm_expand * cfg.d_model

    @property
    def dh(self) -> int:
        return self.d_in // self.cfg.n_heads

    # ------------------------------------------------------------------ init
    @init_on_meta
    def init(self, generator: torch.Generator) -> dict:
        """Random parameters drawn on ``generator``'s device, which must be the
        model's: weights go straight to the device in ``param_dtype``.  On
        ``meta``: the tree drawn from nothing (``transformer.init_on_meta``)."""
        cfg, pdt = self.cfg, self.opts.pdt
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on {self.device}")
        args = (cfg.d_model, self.d_in, cfg.n_heads, pdt)
        return {
            "embed": {"tokens": L.dense_init(generator, (cfg.padded_vocab, cfg.d_model), dtype=pdt)},
            "units": [{"mlstm": [init_mlstm(generator, *args) for _ in range(self.m_per_unit)],
                       "slstm": init_slstm(generator, *args)}
                      for _ in range(self.n_units)],
            "final_norm": L.init_rmsnorm(cfg.d_model, self.device),
            "lm_head": L.dense_init(generator, (cfg.d_model, cfg.padded_vocab), dtype=pdt),
        }

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding: its CUDA backward sums a row's gradients in a fixed order.
        # Laid out at once: a vocab-sharded table's lookup is a masked partial
        # sum, which DTensor can reduce only once
        x = F.embedding(tokens.long(), gather_at_use(params["embed"]["tokens"]).to(self.opts.cdt))
        return lshard(x, "batch", "seq", "embed")

    def _logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        x = L.rmsnorm(gather_at_use(params["final_norm"]), x, self.cfg.norm_eps)
        logits = _mask_padded_vocab(x @ gather_at_use(params["lm_head"]).to(self.opts.cdt),
                                    self.cfg)
        return lshard(logits, "batch", "seq", "vocab")

    def _zero_state(self, batch: int) -> tuple[list[dict], dict]:
        H = self.cfg.n_heads
        return ([mlstm_state(batch, H, self.dh, self.device) for _ in range(self.m_per_unit)],
                slstm_state(batch, H, self.dh, self.device))

    def _unit_fwd(self, up: dict, x: torch.Tensor, m_states: list[dict], s_state: dict):
        """One unit over (b, s, d): (x, its mLSTM states, its sLSTM state).
        The unit's ZeRO-3 weights are gathered here, inside the checkpoint
        (``gather_at_use``)."""
        eps = self.cfg.norm_eps
        up = gather_at_use(up)
        new_m = []
        for lp, st in zip(up["mlstm"], m_states):
            y, st = mlstm_fwd(lp, x, st, eps)
            x = x + y
            new_m.append(st)
        y, s_state = slstm_fwd(up["slstm"], x, s_state, eps)
        return x + y, new_m, s_state

    # --------------------------------------------------------------- forward
    def forward(self, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """batch["tokens"] (b, s) -> (logits (b, s, padded_vocab), aux: a zero
        fp32 scalar, as the reference's).  Every unit starts from the zero
        state, and the final states are dropped."""
        x = self._embed(params, batch["tokens"])
        remat = self.opts.remat and torch.is_grad_enabled()
        for up in params["units"]:
            m_states, s_state = self._zero_state(x.shape[0])
            if remat:
                # a unit draws no random numbers: no RNG state to keep
                x, _, _ = checkpoint(self._unit_fwd, up, x, m_states, s_state,
                                     use_reentrant=False, preserve_rng_state=False)
            else:
                x, _, _ = self._unit_fwd(up, x, m_states, s_state)
        return self._logits(params, x), torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """``layers.cross_entropy`` of the logits: (ce, {"ce", "aux",
        "tokens"}), as the reference's; xLSTM has no aux term."""
        logits, aux = self.forward(params, batch)
        ce, denom = L.cross_entropy(logits, batch["labels"])
        return ce, {"ce": ce, "aux": aux, "tokens": denom}

    # ----------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int) -> dict:
        """Recurrent, O(1) in the sequence (``max_len`` unused): {"states":
        {"mlstm": {"C": (n_units, m_per_unit, b, H, dh, dh), "n", "m"},
        "slstm": {"c", "n", "m", "h": (n_units, b, H, dh)}}, "index"}, fp32,
        the reference's layout."""
        del max_len
        m_st, s_st = self._zero_state(batch)
        return {
            "states": {
                "mlstm": {k: t[None, None].repeat(self.n_units, self.m_per_unit, *[1] * t.dim())
                          for k, t in m_st[0].items()},
                "slstm": {k: t[None].repeat(self.n_units, *[1] * t.dim())
                          for k, t in s_st.items()},
            },
            "index": 0,
        }

    def cache_axes(self) -> dict:
        """Logical axis names of every leaf of ``init_cache``'s tree."""
        m = {
            "C": ("units", "per_unit", "batch", "heads", None, None),
            "n": ("units", "per_unit", "batch", "heads", None),
            "m": ("units", "per_unit", "batch", "heads"),
        }
        s = {k: ("units", "batch", "heads", None) for k in ("c", "n", "m", "h")}
        return {"states": {"mlstm": m, "slstm": s}, "index": ()}

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """One-token decode: tokens (b, 1) -> (logits (b, 1, padded_vocab),
        cache with ``index + 1``); the states are updated in place."""
        x = self._embed(params, tokens)
        m_all, s_all = cache["states"]["mlstm"], cache["states"]["slstm"]
        for u, up in enumerate(params["units"]):
            m_states = [{k: t[u, j] for k, t in m_all.items()} for j in range(self.m_per_unit)]
            x, new_m, s_state = self._unit_fwd(up, x, m_states, {k: t[u] for k, t in s_all.items()})
            for j, st in enumerate(new_m):
                for k, t in st.items():
                    L.write_leading(m_all[k], (u, j), t)
            for k, t in s_state.items():
                L.write_leading(s_all[k], (u,), t)
        return self._logits(params, x), {**cache, "index": cache["index"] + 1}
