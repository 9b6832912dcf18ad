"""qwen3-moe-235b-a22b: Qwen3 MoE 235B (22B active) -- 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,              # per-expert FFN hidden
    vocab=151936,
    n_experts=128,
    top_k=8,
    d_expert=1536,
    head_dim=128,
    notes="128 experts top-8; deepest assigned arch (94L)",
)
