"""Model registry: ``build_model(cfg)`` dispatch, counterpart of the
reference's ``models/model_zoo.py`` for the families ported so far."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import DecoderLM, ModelOptions

# where each family still to be ported stands in ROADMAP.md, queue A
_WAITING = {
    "moe": "item 3 (MoE)",
    "hybrid": "item 4 (Zamba2)",
    "vlm": "item 2 (its patch prefix lives in `forward`)",
    "ssm": "item 6 (remaining families)",
    "audio": "item 6 (remaining families)",
}


def build_model(cfg: ArchConfig, opts: ModelOptions | None = None,
                device: torch.device | str = "cuda") -> DecoderLM:
    """The model for ``cfg`` on ``device`` (a CUDA device unless the caller
    asks for the CPU; asking for CUDA where there is none raises)."""
    if cfg.family == "dense" and not cfg.is_moe:
        return DecoderLM(cfg, opts, device)
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet -- ROADMAP queue A, "
            f"{_WAITING[cfg.family]}"
        )
    raise ValueError(f"unknown family {cfg.family!r}")
