"""Model registry: ``build_model(cfg)`` dispatch, counterpart of the
reference's ``models/model_zoo.py`` for every family (dense, MoE, VLM, SSM,
audio, hybrid).  The reference's ``input_specs`` for its dry-run tooling wait
for the port's launch tooling (ROADMAP.md, queue A)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import DecoderLM, ModelOptions
from repro_torch.models.whisper import WhisperLM
from repro_torch.models.xlstm import XLSTMLM
from repro_torch.models.zamba import ZambaLM


def build_model(cfg: ArchConfig, opts: ModelOptions | None = None,
                device: torch.device | str = "cuda"
                ) -> DecoderLM | XLSTMLM | WhisperLM | ZambaLM:
    """The model for ``cfg`` on ``device`` (a CUDA device unless the caller
    asks for the CPU; asking for CUDA where there is none raises)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, opts, device)
    if cfg.family == "ssm":
        return XLSTMLM(cfg, opts, device)
    if cfg.family == "audio":
        return WhisperLM(cfg, opts, device)
    if cfg.family == "hybrid":
        return ZambaLM(cfg, opts, device)
    raise ValueError(f"unknown family {cfg.family!r}")
