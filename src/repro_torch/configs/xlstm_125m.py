"""xlstm-125m [ssm] — sLSTM + mLSTM blocks.

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304
[arXiv:2405.04517; unverified]

Groups of 3 mLSTM + 1 sLSTM (sLSTM at layers 3, 7, 11).  d_ff=0: blocks use
their internal up/down projections, no separate MLP.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab=50_304,
    slstm_every=4,
    xlstm_proj_factor=2.0,
)
