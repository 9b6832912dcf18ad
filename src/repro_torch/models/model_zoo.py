"""Model registry: ``build_model(cfg)`` dispatch for every family (dense, MoE,
VLM, SSM, audio, hybrid), and stand-ins for every (arch x shape) dry-run
cell's inputs and parameters -- the reference's ``models/model_zoo.py``.

The stand-ins are ``torch.device("meta")`` tensors (the reference's
``ShapeDtypeStruct``s): the reference's shapes and dtypes, no storage.  The
decode cache is ``init_cache`` of a model built on meta (the reference's
``jax.eval_shape`` of it), its ``index`` the Python int the port's caches
hold; ``init`` of such a model builds the parameter tree drawing nothing
(``transformer.init_on_meta``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.transformer import DecoderLM, ModelOptions
from repro_torch.models.whisper import N_FRAMES, WhisperLM
from repro_torch.models.xlstm import XLSTMLM
from repro_torch.models.zamba import ZambaLM

META = torch.device("meta")


def build_model(cfg: ArchConfig, opts: ModelOptions | None = None,
                device: torch.device | str = "cuda"
                ) -> DecoderLM | XLSTMLM | WhisperLM | ZambaLM:
    """The model for ``cfg`` on ``device`` (a CUDA device unless the caller
    asks for the CPU or for ``meta``; asking for CUDA where there is none
    raises)."""
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, opts, device)
    if cfg.family == "ssm":
        return XLSTMLM(cfg, opts, device)
    if cfg.family == "audio":
        return WhisperLM(cfg, opts, device)
    if cfg.family == "hybrid":
        return ZambaLM(cfg, opts, device)
    raise ValueError(f"unknown family {cfg.family!r}")


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def train_input_specs(cfg: ArchConfig, shape: ShapeSpec, opts: ModelOptions | None = None) -> dict:
    """Batch stand-ins for ``train_step`` / prefill forward."""
    opts = opts or ModelOptions()
    b, s = shape.global_batch, shape.seq_len
    specs = {
        "tokens": _spec((b, s), torch.int32),
        "labels": _spec((b, s), torch.int32),
    }
    if cfg.family == "vlm":
        specs["patches"] = _spec((b, cfg.n_patches, cfg.d_model), opts.cdt)
    if cfg.family == "audio":
        specs["frames"] = _spec((b, N_FRAMES, cfg.d_model), opts.cdt)
    return specs


def prefill_input_specs(cfg: ArchConfig, shape: ShapeSpec, opts: ModelOptions | None = None) -> dict:
    specs = train_input_specs(cfg, shape, opts)
    specs.pop("labels")
    return specs


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec, opts: ModelOptions | None = None) -> dict:
    """(tokens, cache) stand-ins for ``serve_step``: one new token against a
    KV cache / recurrent state sized for ``shape.seq_len``."""
    b = shape.global_batch
    cache = build_model(cfg, opts, META).init_cache(b, shape.seq_len)
    return {"tokens": _spec((b, 1), torch.int32), "cache": cache}


def input_specs(cfg: ArchConfig, shape: ShapeSpec, opts: ModelOptions | None = None) -> dict:
    if shape.kind == "train":
        return train_input_specs(cfg, shape, opts)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape, opts)
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape, opts)
    raise ValueError(shape.kind)
