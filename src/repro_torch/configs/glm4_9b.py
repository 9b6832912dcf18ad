"""glm4-9b: THUDM GLM-4 9B -- dense, RoPE, aggressive GQA (kv=2).
[hf:THUDM/glm-4-9b; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,           # extreme GQA
    d_ff=13696,
    vocab=151552,
    head_dim=128,
    rope_theta=10_000.0,
    notes="RoPE, GQA kv=2",
)
