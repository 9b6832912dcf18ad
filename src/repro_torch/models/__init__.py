"""Model zoo of the port: the dense GQA transformer so far."""

from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import DecoderLM, ModelOptions

__all__ = ["build_model", "DecoderLM", "ModelOptions"]
