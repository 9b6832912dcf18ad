"""zamba2-2.7b: Mamba2 backbone + shared attention block every 6 layers.
[arXiv:2411.15242; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_heads=80,           # d_inner=5120, mamba2 head_dim=64
    ssm_expand=2,
    attn_every=6,           # one shared attention block applied every 6
    head_dim=80,
    long_context_window=4096,  # sliding-window cap for long_500k decode
    notes="Mamba2 + shared attn; O(1)/windowed decode state -> long_500k runs",
)
