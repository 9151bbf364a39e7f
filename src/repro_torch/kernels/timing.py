"""The clean-L2 yardstick: the device time of one call on the card.

The autotuner (:mod:`repro_torch.kernels.autotune`), ``chip_smoke.py`` and
``scripts/sod_matmul_probe.py`` all time kernels with :func:`device_ms`.
Before each timed call L2 is left clean: a read of a FLUSH_BYTES buffer (a
reduction, which writes one scalar) evicts every line, and dirty ones are
written back there, not inside the timed call.  A spin kernel after it
keeps the card busy while the host enqueues the call (at least 1 ms, and 4x
the host time of one call), so the CUDA events hold the call's device time
and no host time.  The median of ``reps`` calls is kept.

This file imports only torch and the standard library, so a probe can load
it beside another tree's package.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

__all__ = ["FLUSH_BYTES", "SPIN_HZ", "flush_buffer", "device_ms"]

FLUSH_BYTES = 512 << 20   # > 50 MB L2: every timed call reads from HBM
SPIN_HZ = 2e9             # spin cycles a second: at least the H100's top SM clock


def flush_buffer(device: torch.device | str = "cuda") -> torch.Tensor:
    """The buffer whose read leaves L2 clean, on ``device``."""
    return torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=device)


def device_ms(fn: Callable[[], object], flush: torch.Tensor, reps: int) -> float:
    """Median device time of one call of ``fn`` in ms, on ``flush``'s card,
    each call behind a read of ``flush`` and a spin kernel."""
    dev = flush.device
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    cycles = int(SPIN_HZ * max(1e-3, 4 * (time.perf_counter() - t0)))
    times = []
    for _ in range(reps):
        flush.sum()
        torch.cuda._sleep(cycles)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end))
    return statistics.median(times)
