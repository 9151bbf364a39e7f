"""musicgen-medium [audio] — decoder-only over EnCodec tokens.

48L d_model=1536 24H (GQA kv=24) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf]

The audio frontend is a stub: inputs are 4 parallel EnCodec codebook token
streams; their embeddings are summed, and the head predicts all 4 codebooks
(delay-pattern scheduling is the serving loop's concern).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    rope_theta=10_000.0,
    act="gelu",
    frontend="audio",
    n_codebooks=4,
)
