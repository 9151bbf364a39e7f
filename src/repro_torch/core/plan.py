"""Quantization constants of the packing plan.

Twin of the constants of :mod:`repro.core.plan` that the packed formats
share with the planner (copied, so the port imports nothing of the JAX
package).  The planner itself is not ported yet.
"""
from __future__ import annotations

__all__ = ["QMODES", "QVALUE_BITS", "SCALE_BITS", "CODEBOOK_SIZE"]

#: Quantized value-storage modes (the ``qmode`` axis of the packed formats).
QMODES = ("none", "int8", "fp8", "codebook")
#: Paper-accounting bits per stored value slot under each qmode — codebook
#: slots store only the index into the shared table.
QVALUE_BITS = {"none": 16, "int8": 8, "fp8": 8, "codebook": 4}
#: Bits for one per-tile scale or one codebook entry (side band).
SCALE_BITS = 16
#: Entries in the codebook's shared-value table (entry 0 reserved for 0.0).
CODEBOOK_SIZE = 16
