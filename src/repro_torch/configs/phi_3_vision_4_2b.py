"""phi-3-vision-4.2b: Phi-3-mini backbone + CLIP ViT frontend (STUB).
The modality frontend is a stub: input_specs() provides precomputed patch
embeddings (b, n_patches, d_model).  [hf:microsoft/Phi-3-vision-128k-instruct; hf]"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,          # MHA
    d_ff=8192,
    vocab=32064,
    head_dim=96,
    n_patches=576,          # CLIP-L/14 @ 336px visual prefix
    notes="phi3-mini + CLIP; patch embeds are a stub input",
)
