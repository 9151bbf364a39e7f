"""Continuous-batching serving engine (paged KV cache + request scheduler,
with chunked prefill, preemption with page swapping, copy-on-write prefix
sharing, speculative decoding and a persistent multi-tier prefix cache) over
Sparse-on-Dense packed weights.

Twin of :mod:`repro.serving`."""
from repro_torch.serving.engine import Engine, bucket_len, mesh_static_generate, static_generate
from repro_torch.serving.pool import PagePool, PoolExhausted, PrefixTrie
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import Request, Scheduler, SeqState
from repro_torch.serving.trace import (poisson_trace, repeated_prompt_trace,
                                       shared_prefix_trace, stress_spec_trace)

__all__ = [
    "Engine", "PagePool", "PoolExhausted", "PrefixCache", "PrefixTrie",
    "Request", "Scheduler", "SeqState", "bucket_len", "poisson_trace",
    "repeated_prompt_trace", "shared_prefix_trace", "static_generate", "mesh_static_generate",
    "stress_spec_trace",
]
