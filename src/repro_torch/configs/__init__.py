"""Assigned-architecture registry: ``get_config(name)`` / ``--arch <id>``."""

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.configs.dbrx_132b import CONFIG as DBRX_132B
from repro_torch.configs.glm4_9b import CONFIG as GLM4_9B
from repro_torch.configs.granite_8b import CONFIG as GRANITE_8B
from repro_torch.configs.minicpm_2b import CONFIG as MINICPM_2B
from repro_torch.configs.phi4_mini_3_8b import CONFIG as PHI4_MINI_3_8B
from repro_torch.configs.phi_3_vision_4_2b import CONFIG as PHI_3_VISION_4_2B
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE_235B_A22B
from repro_torch.configs.whisper_tiny import CONFIG as WHISPER_TINY
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M
from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2_2_7B

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        GRANITE_8B,
        MINICPM_2B,
        GLM4_9B,
        PHI4_MINI_3_8B,
        DBRX_132B,
        QWEN3_MOE_235B_A22B,
        PHI_3_VISION_4_2B,
        XLSTM_350M,
        WHISPER_TINY,
        ZAMBA2_2_7B,
    ]
}


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeSpec", "get_config"]
