"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256_000,
    rope_theta=10_000.0,
    sliding_window=4096,
    layer_pattern=("local", "global"),
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_scale=(4608 / 32) ** -0.5,   # query_pre_attn_scalar = d_model/n_heads
    use_post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    act="gelu",
)
