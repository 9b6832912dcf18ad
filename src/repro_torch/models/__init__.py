"""Model zoo of the port: the dense GQA transformer and the Zamba2 hybrid."""

from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import DecoderLM, ModelOptions
from repro_torch.models.zamba import ZambaLM

__all__ = ["build_model", "DecoderLM", "ModelOptions", "ZambaLM"]
