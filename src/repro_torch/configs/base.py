"""Config schema — a copy of the fields of :mod:`repro.configs.base`.

The port keeps its own copy (the JAX module imports ``repro.core.sod`` and
with it JAX); ``tests/test_torch_model.py`` holds the two field sets equal.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.sod import DENSE, SoDConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture: shapes, attention options, numerics and SoD mode."""

    name: str
    family: str                  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # attention
    rope_theta: float = 10000.0
    sliding_window: int | None = None     # for local layers
    layer_pattern: tuple[str, ...] = ("global",)  # repeating local/global
    attn_softcap: float | None = None
    final_softcap: float | None = None
    attn_scale: float | None = None
    use_post_norms: bool = False          # gemma2 sandwich norms
    embed_scale: bool = False             # gemma x*sqrt(d)
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"
    attn_chunk: int = 512

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_shared_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    ep_axis: int = 16
    moe_dispatch_blocks: int = 1
    moe_a2a_axis: str | None = None

    # SSM / hybrid (zamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    hybrid_attn_every: int = 0

    # xLSTM
    slstm_every: int = 0
    xlstm_proj_factor: float = 2.0

    # modality frontend stubs
    frontend: str | None = None
    frontend_dim: int = 0
    n_patches: int = 0
    n_codebooks: int = 0

    # numerics & sparsity
    dtype: str = "bfloat16"
    sod: SoDConfig = DENSE
    remat: bool = True
    scan_layers: bool = True

    def with_(self, **kw) -> "ModelConfig":
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **kw)

    @property
    def padded_vocab(self) -> int:
        """Embedding/head rows ceil-padded to 128; logits at padded ids are
        masked, the logical ``vocab`` is unchanged."""
        return (self.vocab + 127) // 128 * 128

    @property
    def pattern_period(self) -> int:
        """Length of the repeating local/global layer pattern."""
        return len(self.layer_pattern)

    def window_for(self, slot: int) -> int | None:
        """Sliding window of layer ``slot`` (None for global layers)."""
        return self.sliding_window if self.layer_pattern[
            slot % self.pattern_period] == "local" else None
