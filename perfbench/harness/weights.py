"""Seeds of a run: every stream of random numbers the benchmark draws
(weights, token ids, the deal of the traffic, the check's sample) comes
from ``--seed`` and a key of its own.

Weights are drawn on the device with a ``torch.Generator`` there, which
gives the same bits for the same seed, so the reference can draw them again
after the window and both sides see the same tensors.
"""
from __future__ import annotations

import numpy as np
import torch


def stream_seed(seed: int, *key: int) -> int:
    """A 63-bit seed for one stream of the run, from ``--seed`` (any whole
    number) and the stream's key."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *key])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, device, *key: int) -> torch.Generator:
    """A generator on ``device`` for stream ``key`` of the run."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *key))
    return g
