"""dbrx-132b: Databricks DBRX -- fine-grained MoE, 16 experts top-4.
[hf:databricks/dbrx-base; unverified]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    top_k=4,
    d_expert=10752,
    head_dim=128,
    notes="16 experts top-4, fine-grained MoE",
)
