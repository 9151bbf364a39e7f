"""pixtral-12b [vlm] — pixtral-ViT + mistral-nemo backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409; unverified]

The vision frontend is a stub: the caller passes precomputed 1024-d patch
embeddings (``patch_embeds``); the backbone projects and prepends them.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131_072,
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_dim=1024,
    n_patches=1024,
)
