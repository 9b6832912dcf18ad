"""minicpm-2b: MiniCPM 2.4B -- llama-like dense, WSD schedule, tied embeddings.
[arXiv:2404.06395; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,          # MHA (kv=36)
    d_ff=5760,
    vocab=122753,
    head_dim=64,
    tie_embeddings=True,
    lr_schedule="wsd",      # Warmup-Stable-Decay (the paper's contribution)
    notes="WSD schedule (arch=llama-like)",
)
