"""The draft tier of speculative decoding: its packing configuration.

Twin of the draft-tier part of :mod:`repro.runtime.planner`.  Only
:func:`_draft_sod_cfg` and the density ladder are here; the planner proper
(the pack plan, the cost model that picks a draft density) is queue A item
4 of ``ROADMAP.md``, and the caller passes the draft density itself.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.sod import SoDConfig

__all__ = ["DRAFT_DENSITY_LADDER"]

DRAFT_DENSITY_LADDER = (0.05, 0.08, 0.12, 0.2, 0.3, 0.5)


def _draft_sod_cfg(sod_cfg: SoDConfig, density: float,
                   qmode: str | None = None) -> SoDConfig:
    """The draft tier's :class:`~repro_torch.core.sod.SoDConfig`: the
    target's packing geometry (format, tile, prune method) re-pruned to
    ``density``.  A dense target still gets a packed draft, magnitude-pruned
    ``tiled_csc``: the same dense matmul path serves the compressed tier.
    ``qmode`` (optional) stores the draft's values quantized."""
    if sod_cfg.enabled:
        draft = dataclasses.replace(sod_cfg, density=float(density))
    else:
        draft = SoDConfig(mode="tiled_csc", density=float(density),
                          prune_method="magnitude", min_dim=64)
    if qmode is not None:
        draft = dataclasses.replace(draft, qmode=qmode)
    return draft
