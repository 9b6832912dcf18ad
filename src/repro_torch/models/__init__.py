"""Model zoo of the port: the dense / MoE / VLM transformer, the xLSTM, the
Whisper encoder-decoder and the Zamba2 hybrid."""

from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import DecoderLM, ModelOptions
from repro_torch.models.whisper import WhisperLM
from repro_torch.models.xlstm import XLSTMLM
from repro_torch.models.zamba import ZambaLM

__all__ = ["build_model", "DecoderLM", "ModelOptions", "WhisperLM", "XLSTMLM", "ZambaLM"]
