"""Sparse-on-Dense core: formats, pruning, the SoD compute module, and the
paper's analytical cost model.

Re-exports the names the reference's ``repro.core`` exports: the formats
(``TiledCSC``, ``BlockCSR``, ``Bitmap``, their packers, ``pack_csc``,
``unpack_csc``, ``density``), pruning (``magnitude_prune``, ``nm_prune``,
``block_prune``, ``random_sparse``, ``prune_tree``, ``SparsityProfile``,
``PAPER_PROFILES``), the SoD module (``SoDConfig``, ``DENSE``, ``apply``,
``pack_param``) and the topology (``ChipSpec``, ``MeshSpec``,
``SINGLE_POD``, ``MULTI_POD``, ``PAPER_28NM``), with the port's card,
``H100_SXM``, where the reference exports its TPU.  The cost model is
:mod:`repro_torch.core.cost_model`.
"""
from repro_torch.core.formats import (  # noqa: F401
    Bitmap,
    BlockCSR,
    TiledCSC,
    density,
    pack_bitmap,
    pack_block_csr,
    pack_csc,
    pack_tiled_csc,
    unpack_csc,
)
from repro_torch.core.pruning import (  # noqa: F401
    PAPER_PROFILES,
    SparsityProfile,
    block_prune,
    magnitude_prune,
    nm_prune,
    prune_tree,
    random_sparse,
)
from repro_torch.core.sod import DENSE, SoDConfig, apply, pack_param  # noqa: F401
from repro_torch.core.topology import (  # noqa: F401
    H100_SXM,
    MULTI_POD,
    PAPER_28NM,
    SINGLE_POD,
    ChipSpec,
    MeshSpec,
)
