"""granite-8b: IBM Granite 8B (code) -- llama-arch dense transformer.
[arXiv:2405.04324; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,           # GQA
    d_ff=14336,
    vocab=49152,
    head_dim=128,
    rope_theta=10_000_000.0,
    notes="llama-arch, code model; RoPE + SwiGLU + GQA",
)
