"""Model zoo of the port: the dense / MoE / VLM transformer, the xLSTM, the
Whisper encoder-decoder and the Zamba2 hybrid, and the dry run's input
stand-ins."""

from repro_torch.models.model_zoo import (
    build_model,
    decode_input_specs,
    input_specs,
    prefill_input_specs,
    train_input_specs,
)
from repro_torch.models.transformer import DecoderLM, ModelOptions
from repro_torch.models.whisper import WhisperLM
from repro_torch.models.xlstm import XLSTMLM
from repro_torch.models.zamba import ZambaLM

__all__ = [
    "build_model", "input_specs", "train_input_specs",
    "prefill_input_specs", "decode_input_specs", "DecoderLM", "ModelOptions", "WhisperLM",
    "XLSTMLM", "ZambaLM",
]
