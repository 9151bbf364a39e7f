"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]

54 mamba2 layers; one weight-shared attention+MLP block is applied every 6
mamba layers (9 applications).  Zamba2's per-application LoRA deltas on the
shared block are omitted, as in the reference.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab=32_000,
    rope_theta=10_000.0,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    hybrid_attn_every=6,
)
