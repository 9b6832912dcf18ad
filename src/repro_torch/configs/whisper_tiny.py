"""whisper-tiny: encoder-decoder ASR; conv frontend is a STUB (input_specs()
provides precomputed frame embeddings).  [arXiv:2212.04356; unverified]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,             # decoder layers
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    notes="enc-dec; conv frontend stubbed as precomputed frame embeddings",
)
