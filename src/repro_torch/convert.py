"""Parameter conversion from the reference's pytree to the port's.

The reference stacks the layers on a leading axis (``jax.vmap`` over the layer
keys); the port holds a list of per-layer dictionaries.  Apart from that the
two layouts agree leaf for leaf: weights are ``(d_in, d_out)`` and applied as
``x @ W``.  The caller hands the reference's parameters over as numpy arrays,
so this module needs neither framework of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _leaf(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32), dtype=dtype, device=device)


def from_jax_params(tree: dict, cfg: ArchConfig, dtype: torch.dtype = torch.float32,
                    device: torch.device | str = "cpu") -> dict:
    """``tree``: the reference ``DecoderLM.init`` pytree with numpy leaves
    (dense family).  Weights are cast to ``dtype``; norm scales stay fp32."""
    layers = tree["layers"]
    if "moe" in layers or "patch_proj" in tree:
        raise NotImplementedError("only the dense family is ported so far")
    n_layers = np.asarray(layers["attn"]["wq"]).shape[0]
    if n_layers != cfg.n_layers:
        raise ValueError(f"pytree has {n_layers} layers, config {cfg.name} has {cfg.n_layers}")

    def norm(p, i=None):
        scale = p["norm_scale"] if i is None else p["norm_scale"][i]
        return {"norm_scale": _leaf(scale, torch.float32, device)}

    params = {
        "embed": {"tokens": _leaf(tree["embed"]["tokens"], dtype, device)},
        "layers": [
            {
                "attn": {n: _leaf(layers["attn"][n][i], dtype, device)
                         for n in ("wq", "wk", "wv", "wo")},
                "attn_norm": norm(layers["attn_norm"], i),
                "ffn_norm": norm(layers["ffn_norm"], i),
                "mlp": {n: _leaf(layers["mlp"][n][i], dtype, device)
                        for n in ("w_gate", "w_in", "w_out")},
            }
            for i in range(n_layers)
        ],
        "final_norm": norm(tree["final_norm"]),
    }
    if "lm_head" in tree:
        params["lm_head"] = _leaf(tree["lm_head"], dtype, device)
    return params
