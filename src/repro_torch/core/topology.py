"""Hardware constants for roofline analysis and the paper's cost model.

Twin of :mod:`repro.core.topology`.  Two parameter sets coexist:

  * ``H100_SXM`` — the port's card (roofline terms: the kernels' bounds in
    ``chip_smoke.py`` and ``scripts/sod_matmul_probe.py``, the autotuner's
    prior).  The reference's chip is a TPU; the port states no rate taken
    for one, so ``TPU_V5E`` is not carried over.
  * ``PAPER_28NM`` — the paper's 28nm CMOS evaluation context, used by
    :mod:`repro_torch.core.cost_model` to reproduce the paper's figures.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One accelerator chip, as seen by the roofline model."""

    name: str
    peak_bf16_flops: float   # FLOP/s
    hbm_bandwidth: float     # bytes/s
    ici_link_bandwidth: float  # bytes/s per link
    ici_links: int           # links per chip (2D torus: 4)
    hbm_bytes: int           # capacity
    vmem_bytes: int          # usable VMEM per core
    clock_hz: float

    @property
    def flops_per_byte_balance(self) -> float:
        return self.peak_bf16_flops / self.hbm_bandwidth


# NVIDIA H100 SXM5 80GB, from NVIDIA's data sheet at the 700 W power limit
# (dense rates, no structured sparsity).  The fields keep the reference's
# TPU names; on this card they mean:
H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_bf16_flops=989e12,     # bf16 tensor-core peak, dense
    hbm_bandwidth=3.35e12,      # HBM3
    ici_link_bandwidth=25e9,    # one NVLink 4 link, each way
    ici_links=18,               # NVLink 4 links per card (900 GB/s both ways)
    hbm_bytes=80 * 10**9,       # the data sheet's nominal 80 GB of HBM3
    vmem_bytes=228 * 1024,      # shared memory per SM (a TPU core's VMEM)
    clock_hz=1.98e9,            # SM boost clock
)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh used for the roofline collective term."""

    axes: tuple[str, ...]
    shape: tuple[int, ...]
    chip: ChipSpec = H100_SXM

    @property
    def num_chips(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        return self.shape[self.axes.index(name)]


# the reference's meshes, as logical meshes (no mesh of this size is run)
SINGLE_POD = MeshSpec(axes=("data", "model"), shape=(16, 16))
MULTI_POD = MeshSpec(axes=("pod", "data", "model"), shape=(2, 16, 16))


# ---------------------------------------------------------------------------
# Paper's 28 nm evaluation context (Section IV).  Energy numbers are standard
# 28/45 nm scaling values (Horowitz ISSCC'14 style) that reproduce the
# qualitative and quantitative behaviour reported in the paper: DRAM access
# dominates, SRAM ~1-2 orders below, MAC lowest.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PaperTech:
    name: str = "28nm"
    clock_hz: float = 500e6
    # energy per element-access / op (pJ), 16-bit datapath
    e_dram_per_bit: float = 20.0      # pJ/bit off-chip DRAM
    e_sram_per_bit: float = 0.35      # pJ/bit large global SRAM buffer
    e_mac_16b: float = 1.0            # pJ per 16-bit MAC (mult+add+reg)
    e_index_match: float = 0.25       # pJ per index comparison (sparse PEs)
    e_fifo_per_bit: float = 0.10      # pJ/bit FIFO traversal
    # area, mm^2 (28nm; calibrated so the dense baseline reproduces the
    # paper's Table II absolute TOPS/mm²: 0.956 logic-only, 0.430 +2MB SRAM)
    a_dense_pe: float = 1.046e-3      # one 16-bit MAC PE incl. pipeline regs
    a_sram_per_kb: float = 2.56e-3    # global buffer SRAM
    # value/index bit widths used throughout the paper
    bits_value: int = 16
    bits_index: int = 8


PAPER_28NM = PaperTech()
