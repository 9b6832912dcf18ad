"""Parameter conversion between the reference's pytree and the port's.

The reference stacks the layers on a leading axis (``jax.vmap`` over the layer
keys; the Zamba2 hybrid on two, ``(n_units, attn_every, ...)``; the xLSTM its
mLSTM blocks on two, ``(n_units, m_per_unit, ...)``, and its sLSTM blocks on
one); the port holds lists of per-layer dictionaries.  Apart from that the two layouts agree
leaf for leaf: weights are ``(d_in, d_out)`` and applied as ``x @ W``.  The caller hands the reference's parameters over as numpy arrays,
so this module needs neither framework of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import resolve_device


def _leaf(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), dtype=dtype, device=device)


def _norm(p, i=None, device="cpu") -> dict:
    scale = p["norm_scale"] if i is None else p["norm_scale"][i]
    return {"norm_scale": _leaf(scale, torch.float32, device)}


# Leaves kept in fp32 whatever ``dtype`` is: the reference reads them as fp32
# at every use, and their values must survive exactly (Mamba2's, the MoE router).
_FP32_LEAVES = ("A_log", "D", "dt_bias", "router")


def _block(stacked: dict, index, dtype: torch.dtype, device) -> dict:
    """Block ``index`` of a tree of groups of stacked leaves: {group: {name:
    leaf[index]}}, norm scales and ``_FP32_LEAVES`` in fp32, the rest in
    ``dtype``."""
    return {group: {name: _leaf(np.asarray(w)[index],
                                torch.float32 if name in _FP32_LEAVES or name == "norm_scale"
                                else dtype, device)
                    for name, w in leaves.items()}
            for group, leaves in stacked.items()}


def _xlstm_params(tree: dict, cfg: ArchConfig, dtype: torch.dtype, device) -> dict:
    units = tree["units"]
    n_units, per_unit = np.asarray(units["mlstm"]["ssm"]["w_in"]).shape[:2]
    if n_units * (per_unit + 1) != cfg.n_layers or per_unit + 1 != cfg.slstm_every:
        raise ValueError(f"pytree has {n_units} units of {per_unit} mLSTM + 1 sLSTM blocks, "
                         f"config {cfg.name} has {cfg.n_layers} layers, an sLSTM every "
                         f"{cfg.slstm_every}")
    device = resolve_device(device)
    return {
        "embed": {"tokens": _leaf(tree["embed"]["tokens"], dtype, device)},
        "units": [{"mlstm": [_block(units["mlstm"], (u, j), dtype, device)
                             for j in range(per_unit)],
                   "slstm": _block(units["slstm"], u, dtype, device)}
                  for u in range(n_units)],
        "final_norm": _norm(tree["final_norm"], device=device),
        "lm_head": _leaf(tree["lm_head"], dtype, device),
    }


def _whisper_params(tree: dict, cfg: ArchConfig, dtype: torch.dtype, device) -> dict:
    stacks = {name: np.asarray(tree[name]["attn"]["wq"]).shape[0]
              for name in ("enc_layers", "dec_layers")}
    if (stacks["enc_layers"], stacks["dec_layers"]) != (cfg.n_encoder_layers, cfg.n_layers):
        raise ValueError(f"pytree has {stacks['enc_layers']} encoder and {stacks['dec_layers']} "
                         f"decoder layers, config {cfg.name} has {cfg.n_encoder_layers} and "
                         f"{cfg.n_layers}")
    device = resolve_device(device)
    return {
        "embed": {"tokens": _leaf(tree["embed"]["tokens"], dtype, device)},
        "frame_proj": _leaf(tree["frame_proj"], dtype, device),
        **{name: [_block(tree[name], i, dtype, device) for i in range(n)]
           for name, n in stacks.items()},
        "enc_norm": _norm(tree["enc_norm"], device=device),
        "final_norm": _norm(tree["final_norm"], device=device),
    }


def _zamba_params(tree: dict, cfg: ArchConfig, dtype: torch.dtype, device) -> dict:
    units = tree["units"]
    n_units, per_unit = np.asarray(units["ssm"]["w_in"]).shape[:2]
    if n_units * per_unit != cfg.n_layers or per_unit != cfg.attn_every:
        raise ValueError(f"pytree has {n_units} units of {per_unit} layers, config {cfg.name} "
                         f"has {cfg.n_layers} layers, a unit every {cfg.attn_every}")
    device = resolve_device(device)
    shared = tree["shared"]
    return {
        "embed": {"tokens": _leaf(tree["embed"]["tokens"], dtype, device)},
        "layers": [
            {
                "ssm": {n: _leaf(w[u][j], torch.float32 if n in _FP32_LEAVES else dtype, device)
                        for n, w in units["ssm"].items()},
                "norm": _norm(units["norm"], (u, j), device),
            }
            for u in range(n_units) for j in range(per_unit)
        ],
        "shared": {
            "attn": {n: _leaf(w, dtype, device) for n, w in shared["attn"].items()},
            "attn_norm": _norm(shared["attn_norm"], device=device),
            "mlp": {n: _leaf(w, dtype, device) for n, w in shared["mlp"].items()},
            "mlp_norm": _norm(shared["mlp_norm"], device=device),
        },
        "final_norm": _norm(tree["final_norm"], device=device),
        "lm_head": _leaf(tree["lm_head"], dtype, device),
    }


def from_jax_params(tree: dict, cfg: ArchConfig, dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cuda", mesh=None) -> dict:
    """``tree``: the reference ``DecoderLM.init`` (dense, MoE or VLM family),
    ``XLSTMLM.init`` (ssm), ``WhisperLM.init`` (audio) or ``ZambaLM.init``
    (hybrid) pytree with numpy leaves, told apart by their keys (the xLSTM's
    and the hybrid's both hold ``units``).  Weights are cast to ``dtype``; norm
    scales, the MoE router and the Mamba2 ``A_log``/``D``/``dt_bias`` stay
    fp32.  The tensors go to ``device``, the card unless the caller asks for
    the CPU; once the tree is checked, a missing card raises.  With a ``mesh``
    (a DeviceMesh; every rank converts the same tree) the leaves come back as
    DTensors laid out by ``parallel.sharding.param_shardings``, as the meshed
    train and serve steps hold them."""
    if mesh is not None:
        from repro_torch.parallel import sharding as shd

        params = from_jax_params(tree, cfg, dtype, device)
        return shd.lay_out_tree(params, shd.param_shardings(params, mesh))
    if "enc_layers" in tree:
        return _whisper_params(tree, cfg, dtype, device)
    if "units" in tree and "mlstm" in tree["units"]:
        return _xlstm_params(tree, cfg, dtype, device)
    if "shared" in tree:
        return _zamba_params(tree, cfg, dtype, device)
    layers = tree["layers"]
    ffn = "moe" if "moe" in layers else "mlp"
    n_layers = np.asarray(layers["attn"]["wq"]).shape[0]
    if n_layers != cfg.n_layers:
        raise ValueError(f"pytree has {n_layers} layers, config {cfg.name} has {cfg.n_layers}")
    device = resolve_device(device)

    params = {
        "embed": {"tokens": _leaf(tree["embed"]["tokens"], dtype, device)},
        "layers": [
            {
                "attn": {n: _leaf(layers["attn"][n][i], dtype, device)
                         for n in ("wq", "wk", "wv", "wo")},
                "attn_norm": _norm(layers["attn_norm"], i, device),
                "ffn_norm": _norm(layers["ffn_norm"], i, device),
                ffn: {n: _leaf(w[i], torch.float32 if n in _FP32_LEAVES else dtype, device)
                      for n, w in layers[ffn].items()},
            }
            for i in range(n_layers)
        ],
        "final_norm": _norm(tree["final_norm"], device=device),
    }
    for name in ("lm_head", "patch_proj"):
        if name in tree:
            params[name] = _leaf(tree[name], dtype, device)
    return params


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _stack(layers: list[dict], shape: tuple[int, ...]) -> dict:
    """Per-layer leaves stacked on leading axes of ``shape``, group by group."""
    return {group: {name: np.stack([_host(lp[group][name]) for lp in layers]).reshape(
                        *shape, *layers[0][group][name].shape)
                    for name in leaves}
            for group, leaves in layers[0].items()}


def to_jax_layout(tree: dict, cfg: ArchConfig | None = None) -> dict:
    """The inverse of :func:`from_jax_params`: the port's tree (parameters,
    or gradients of the same shape) as fp32 numpy arrays in the reference's
    layout.  Dense, MoE and VLM families: each per-layer leaf stacked on a
    leading ``(n_layers, ...)`` axis.  xLSTM: ``units.mlstm`` stacked
    ``(n_units, m_per_unit, ...)`` and ``units.slstm`` ``(n_units, ...)``.
    Whisper: ``enc_layers`` and ``dec_layers`` each stacked ``(n, ...)``,
    beside ``frame_proj`` and ``enc_norm``.  Hybrid (``cfg`` names
    ``attn_every``): the Mamba2 layers as the reference's ``units``, stacked
    ``(n_units, attn_every, ...)``, beside ``shared``.  Each with ``embed``,
    ``final_norm`` and ``lm_head`` where it has one."""
    out = {
        "embed": {"tokens": _host(tree["embed"]["tokens"])},
        "final_norm": {"norm_scale": _host(tree["final_norm"]["norm_scale"])},
    }
    if "enc_layers" in tree:
        for name in ("enc_layers", "dec_layers"):
            out[name] = _stack(tree[name], (len(tree[name]),))
        out["enc_norm"] = {"norm_scale": _host(tree["enc_norm"]["norm_scale"])}
    elif "units" in tree:
        units = tree["units"]
        out["units"] = {
            "mlstm": _stack([lp for up in units for lp in up["mlstm"]],
                            (len(units), len(units[0]["mlstm"]))),
            "slstm": _stack([up["slstm"] for up in units], (len(units),)),
        }
    elif "shared" in tree:
        layers = tree["layers"]
        if cfg is None or len(layers) % cfg.attn_every:
            raise ValueError("a hybrid tree needs the config whose attn_every cuts its "
                             f"{len(layers)} layers into units")
        out["units"] = _stack(layers, (len(layers) // cfg.attn_every, cfg.attn_every))
        out["shared"] = {group: {name: _host(w) for name, w in leaves.items()}
                         for group, leaves in tree["shared"].items()}
    else:
        out["layers"] = _stack(tree["layers"], (len(tree["layers"]),))
    for name in ("lm_head", "patch_proj", "frame_proj"):
        if name in tree:
            out[name] = _host(tree[name])
    return out
