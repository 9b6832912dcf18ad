"""Plain fp32 forward and loss of the dense decoder (GQA, RoPE on interleaved
pairs, SwiGLU, RMSNorm, untied head) and of the Zamba2 hybrid (Mamba2 layers
with the SSD recurrence, one shared attention + MLP block after every
``attn_every`` of them), written from the architectures' equations:

    RMSNorm(x) = x / sqrt(mean(x^2) + eps) * scale
    attention: softmax(q k^T / sqrt(hd), causal) v, query head h reading KV
        head h // (H / K); RoPE rotates (x[2i], x[2i+1]) by pos / theta^(2i/hd)
    MLP: (silu(x W_gate) * (x W_in)) W_out
    Mamba2: [z, xBC, dt] = RMSNorm(x) W_in; xBC = silu(causal depthwise conv
        (window 4) of xBC); dt = softplus(dt + dt_bias); a_t = exp(-dt exp(A_log));
        S_t = a_t S_{t-1} + dt_t x_t B_t^T; y_t = S_t C_t + D x_t;
        out = (y * silu(z)) W_out
    loss: mean next-token cross-entropy over the vocabulary (the rows padded
        to a multiple of 256 are masked out)

The scan runs chunk by chunk (the quadratic form inside a chunk of 128, the
state carried between chunks), which is the recurrence's arithmetic regrouped.
Layers run under ``torch.utils.checkpoint`` and the loss in blocks of rows,
so that a full-depth model fits beside its fp32 optimizer state.

``Precision`` rounds the operands of every matrix product: ``fp32`` is the
reference; ``fp8`` (e4m3, one scale a tensor, fp32 accumulation) is the
control, the step below the bf16 compute the configurations state."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MASK = -1e30
CONV_K = 4
CHUNK = 128
LOSS_ROWS = 1024


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}")
        self.name = name

    def round(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the product sees it (straight through for the gradient)."""
        if self.name == "fp32":
            return t
        scale = 448.0 / t.detach().abs().amax().clamp(min=1e-30)
        q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return t + (q - t).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)


def arch_dims(arch: dict) -> dict:
    d = dict(arch)
    d["head_dim"] = arch.get("head_dim") or arch["d_model"] // arch["n_heads"]
    d["padded_vocab"] = (arch["vocab"] + 255) // 256 * 256
    d["d_in"] = arch.get("ssm_expand", 2) * arch["d_model"]
    return d


def param_spec(arch: dict) -> dict:
    """{dotted path: shape} of every parameter."""
    a = arch_dims(arch)
    d, hd, H, K, V = a["d_model"], a["head_dim"], a["n_heads"], a["n_kv_heads"], a["padded_vocab"]

    def attn(p):
        return {f"{p}.wq": (d, H * hd), f"{p}.wk": (d, K * hd), f"{p}.wv": (d, K * hd),
                f"{p}.wo": (H * hd, d)}

    def mlp(p):
        ff = a["d_ff"]
        return {f"{p}.w_gate": (d, ff), f"{p}.w_in": (d, ff), f"{p}.w_out": (ff, d)}

    spec = {"embed.tokens": (V, d), "final_norm.norm_scale": (d,)}
    if not a.get("tie_embeddings"):
        spec["lm_head"] = (d, V)
    if a["family"] == "dense":
        for i in range(a["n_layers"]):
            spec.update(attn(f"layers.{i}.attn"))
            spec.update(mlp(f"layers.{i}.mlp"))
            spec[f"layers.{i}.attn_norm.norm_scale"] = (d,)
            spec[f"layers.{i}.ffn_norm.norm_scale"] = (d,)
        return spec
    if a["family"] != "hybrid":
        raise ValueError(f"no reference for the family {a['family']!r}")
    d_in, N, Hs = a["d_in"], a["ssm_state"], a["ssm_heads"]
    for i in range(a["n_layers"]):
        p = f"layers.{i}"
        spec.update({f"{p}.ssm.w_in": (d, 2 * d_in + 2 * N + Hs), f"{p}.ssm.conv_w": (CONV_K, d_in + 2 * N),
                     f"{p}.ssm.A_log": (Hs,), f"{p}.ssm.D": (Hs,), f"{p}.ssm.dt_bias": (Hs,),
                     f"{p}.ssm.w_out": (d_in, d), f"{p}.norm.norm_scale": (d,)})
    spec.update(attn("shared.attn"))
    spec.update(mlp("shared.mlp"))
    spec["shared.attn_norm.norm_scale"] = (d,)
    spec["shared.mlp_norm.norm_scale"] = (d,)
    return spec


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x (b, s, h, hd), positions 0 .. s-1."""
    hd, s = x.shape[-1], x.shape[1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def attention(p, pre, x, a, prec):
    b, s, _ = x.shape
    H, K, hd = a["n_heads"], a["n_kv_heads"], a["head_dim"]
    q = rope(prec.mm(x, p[f"{pre}.wq"]).view(b, s, H, hd), a["rope_theta"])
    k = rope(prec.mm(x, p[f"{pre}.wk"]).view(b, s, K, hd), a["rope_theta"])
    v = prec.mm(x, p[f"{pre}.wv"]).view(b, s, K, hd)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    k = k.repeat_interleave(H // K, dim=1)
    v = v.repeat_interleave(H // K, dim=1)
    scores = prec.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(torch.where(causal, scores, MASK), dim=-1)
    out = prec.mm(probs, v).transpose(1, 2).reshape(b, s, H * hd)
    return prec.mm(out, p[f"{pre}.wo"])


def mlp(p, pre, x, prec):
    return prec.mm(F.silu(prec.mm(x, p[f"{pre}.w_gate"])) * prec.mm(x, p[f"{pre}.w_in"]),
                   p[f"{pre}.w_out"])


def causal_conv(x, w):
    """Depthwise causal conv: out_t = sum_i w[i] x_{t - (K-1) + i}."""
    k, s = w.shape[0], x.shape[1]
    full = F.pad(x, (0, 0, k - 1, 0))
    return sum(full[:, i: i + s] * w[i] for i in range(k))


def ssd(x, B, C, dt, loga, chunk=CHUNK):
    """y_t = S_t C_t with S_t = exp(loga_t) S_{t-1} + dt_t x_t B_t^T, S_0 = 0.
    x (b, s, H, P); B, C (b, s, N); dt, loga (b, s, H).  -> y (b, s, H, P)."""
    b, s, H, P = x.shape
    N = B.shape[-1]
    pad = -s % chunk
    if pad:
        x, B, C, dt, loga = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, B, C, dt, loga))
    nc = x.shape[1] // chunk
    x = x.reshape(b, nc, chunk, H, P)
    B, C = B.reshape(b, nc, chunk, N), C.reshape(b, nc, chunk, N)
    dt, loga = dt.reshape(b, nc, chunk, H), loga.reshape(b, nc, chunk, H)
    cum = torch.cumsum(loga.double(), dim=2).float()                   # (b, c, t, H)
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    decay = cum[:, :, :, None, :] - cum[:, :, None, :, :]              # (b, c, t, u, H)
    gate = torch.where(tri, torch.exp(torch.where(tri, decay, 0.0)), 0.0)
    cb = torch.einsum("bctn,bcun->bctu", C, B)
    w = gate * cb[..., None] * dt[:, :, None, :, :]
    y = torch.einsum("bctuh,bcuhp->bcthp", w, x)
    w_state = torch.exp(cum[:, :, -1:, :] - cum) * dt                  # (b, c, u, H)
    states = torch.einsum("bcuh,bcuhp,bcun->bchpn", w_state, x, B)
    S = torch.zeros(b, H, P, N, dtype=x.dtype, device=x.device)
    carried = []
    for c in range(nc):
        carried.append(S)
        S = S * torch.exp(cum[:, c, -1, :])[:, :, None, None] + states[:, c]
    S_in = torch.stack(carried, dim=1)                                 # (b, c, H, P, N)
    y = y + torch.einsum("bctn,bchpn->bcthp", C, S_in) * torch.exp(cum)[..., None]
    return y.reshape(b, nc * chunk, H, P)[:, :s]


def mamba(p, pre, x, a, prec):
    b, s, _ = x.shape
    d_in, N, H = a["d_in"], a["ssm_state"], a["ssm_heads"]
    proj = prec.mm(rmsnorm(x, p[f"{pre}.norm.norm_scale"], a["norm_eps"]), p[f"{pre}.ssm.w_in"])
    z, xbc, dt = proj[..., :d_in], proj[..., d_in: 2 * d_in + 2 * N], proj[..., -H:]
    xbc = F.silu(causal_conv(xbc, p[f"{pre}.ssm.conv_w"]))
    xc, B, C = xbc[..., :d_in], xbc[..., d_in: d_in + N], xbc[..., d_in + N:]
    dt = F.softplus(dt + p[f"{pre}.ssm.dt_bias"])
    loga = dt * -torch.exp(p[f"{pre}.ssm.A_log"])
    xh = xc.reshape(b, s, H, d_in // H)
    y = ssd(xh, B, C, dt, loga) + xh * p[f"{pre}.ssm.D"][:, None]
    y = y.reshape(b, s, d_in) * F.silu(z)
    return prec.mm(y, p[f"{pre}.ssm.w_out"])


def _dense_layer(p, i, x, a, prec):
    pre = f"layers.{i}"
    x = x + attention(p, f"{pre}.attn", rmsnorm(x, p[f"{pre}.attn_norm.norm_scale"], a["norm_eps"]), a, prec)
    return x + mlp(p, f"{pre}.mlp", rmsnorm(x, p[f"{pre}.ffn_norm.norm_scale"], a["norm_eps"]), prec)


def _shared_block(p, x, a, prec):
    x = x + attention(p, "shared.attn", rmsnorm(x, p["shared.attn_norm.norm_scale"], a["norm_eps"]), a, prec)
    return x + mlp(p, "shared.mlp", rmsnorm(x, p["shared.mlp_norm.norm_scale"], a["norm_eps"]), prec)


def _mamba_layer(p, i, x, a, prec):
    return x + mamba(p, f"layers.{i}", x, a, prec)


def hidden(p: dict, tokens: torch.Tensor, arch: dict, prec: Precision) -> torch.Tensor:
    """The final RMSNorm's output (b, s, d) for ``tokens`` (b, s)."""
    a = arch_dims(arch)
    x = F.embedding(tokens.long(), p["embed.tokens"])
    run = lambda f, *args: checkpoint(f, p, *args, a, prec, use_reentrant=False)  # noqa: E731
    if a["family"] == "dense":
        for i in range(a["n_layers"]):
            x = run(_dense_layer, i, x)
    else:
        for i in range(a["n_layers"]):
            x = run(_mamba_layer, i, x)
            if (i + 1) % a["attn_every"] == 0:
                x = run(_shared_block, x)
    return rmsnorm(x, p["final_norm.norm_scale"], a["norm_eps"])


def _nll_sum(h, head, labels, vocab, prec):
    logits = prec.mm(h, head)
    logits = torch.where(torch.arange(logits.shape[-1], device=h.device) < vocab, logits, MASK)
    return -torch.log_softmax(logits, dim=-1).gather(-1, labels.long()[:, None]).sum()


def loss(p: dict, batch: dict, arch: dict, prec: Precision) -> torch.Tensor:
    """Mean next-token cross-entropy over every position of the batch."""
    a = arch_dims(arch)
    h = hidden(p, batch["tokens"], arch, prec)
    head = p["embed.tokens"].T if a.get("tie_embeddings") else p["lm_head"]
    h, labels = h.reshape(-1, h.shape[-1]), batch["labels"].reshape(-1)
    total = sum(checkpoint(_nll_sum, h[r: r + LOSS_ROWS], head, labels[r: r + LOSS_ROWS], a["vocab"],
                           prec, use_reentrant=False)
                for r in range(0, h.shape[0], LOSS_ROWS))
    return total / h.shape[0]
