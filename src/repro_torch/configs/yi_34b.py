"""yi-34b [dense] — llama-arch GQA.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[arXiv:2403.04652; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab=64_000,
    rope_theta=5_000_000.0,
)
