"""The yardstick: the card's peaks and the work a call or a token needs.

Counted from the configuration and the seed's pruned weights (how many
values the named format stores), never from the program's tensors, so a
change to the program's padding, capacity or layout leaves these numbers
as they are.  The rules are those of ``chip_smoke.py``'s ``_work`` and
``_bound``, frozen here:

* operations: 2 x rows x stored values, the rows being the call's real
  tokens (decoding rows, or a prompt's tokens; rows the engine pads with
  and a prefill bucket's padding do not count);
* bytes: x read once (rows x K, bf16), y written once (rows x N, bf16, or
  float32 for the LM head), and the weight as the named format stores it:
  ``tiled_csc`` a bf16 value and a one-byte row index a stored value
  (128-row tiles); ``block_csr`` every kept (br, bc) block of bf16 values
  with a 4-byte block id, and a 4-byte count a (128, 128) macro tile;
* bound: the larger of operations / peak and bytes / bandwidth.

FLOPs of a token are its useful work: 2 x stored values of every
projection, and attention's score and value products, 4 x heads x
head_dim x the keys it attends to, a layer; the LM head only where its
logits are used (a decoding token, a prompt's last position).
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense bf16 tensor-core rate and HBM3
# bandwidth at the 700 W limit (the values of the port's core/topology.py
# H100_SXM, copied so that a change there does not move this yardstick)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
ACT_BYTES = 2            # bf16 activations


@dataclasses.dataclass(frozen=True)
class Matrix:
    """One packed projection: its name, (K, N), the values its format
    stores, and the bytes of one output element."""

    name: str
    k: int
    n: int
    stored: int
    out_bytes: int = ACT_BYTES


def weight_bytes(mat: Matrix, sod: dict) -> int:
    if sod["mode"] == "tiled_csc":
        return mat.stored * (ACT_BYTES + 1)
    if sod["mode"] == "block_csr":
        bt, bc = sod["tile"]
        blocks = mat.stored // (sod["br"] * bc)
        tiles = -(-mat.k // bt) * -(-mat.n // bc)
        return mat.stored * ACT_BYTES + 4 * blocks + 4 * tiles
    raise ValueError(f"no yardstick for SoD mode {sod['mode']!r}")


def call_work(rows: int, mat: Matrix, sod: dict) -> tuple[int, int]:
    """(bytes, operations) of one call of ``mat`` on ``rows`` real rows."""
    nbytes = rows * mat.k * ACT_BYTES + weight_bytes(mat, sod) + rows * mat.n * mat.out_bytes
    return nbytes, 2 * rows * mat.stored


def bound_s(nbytes: int, ops: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16_FLOPS)


def pass_bound_s(rows: int, mats: list[Matrix], sod: dict) -> float:
    """Least time of one forward's calls (every matrix once) on ``rows``."""
    return sum(bound_s(*call_work(rows, m, sod)) for m in mats)


@dataclasses.dataclass(frozen=True)
class Model:
    """What the FLOP counts need of a configuration: its layers' and head's
    stored values, and its attention geometry."""

    layer_stored: int          # stored values of every layer's projections
    head_stored: int
    n_layers: int
    n_heads: int
    head_dim: int

    def attn_flops(self, keys: int) -> float:
        return 4.0 * self.n_layers * self.n_heads * self.head_dim * keys

    def decode_flops(self, pos: int) -> float:
        """A token fed at position ``pos`` (0-based), whose logits are used."""
        return 2.0 * (self.layer_stored + self.head_stored) + self.attn_flops(pos + 1)

    def prompt_flops(self, plen: int) -> float:
        """A prompt of ``plen`` tokens, causal, logits at its last position."""
        return (2.0 * self.layer_stored * plen + self.attn_flops(plen * (plen + 1) // 2)
                + 2.0 * self.head_stored)
