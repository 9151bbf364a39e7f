"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Experts ceil-pad to the EP axis (60 → 64 on a 16-way model axis); the router
masks the padding.  The 4 shared experts are fused into one
always-on MLP of hidden 4·1408 = 5632 with a sigmoid gate, as in the HF
implementation.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=151_936,
    rope_theta=1_000_000.0,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    d_shared_ff=5632,
    tie_embeddings=False,
)
