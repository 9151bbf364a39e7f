"""Continuous-batching serving engine (paged KV cache + request scheduler,
with chunked prefill) over Sparse-on-Dense packed weights.

Twin of :mod:`repro.serving` for the stages ported so far; the prefix cache
(``PrefixCache``) and the speculative-decoding stress trace
(``stress_spec_trace``) come with their stages."""
from repro_torch.serving.engine import Engine, bucket_len, static_generate
from repro_torch.serving.pool import PagePool, PoolExhausted, PrefixTrie
from repro_torch.serving.scheduler import Request, Scheduler, SeqState
from repro_torch.serving.trace import (poisson_trace, repeated_prompt_trace,
                                       shared_prefix_trace)

__all__ = [
    "Engine", "PagePool", "PoolExhausted", "PrefixTrie", "Request",
    "Scheduler", "SeqState", "bucket_len", "poisson_trace",
    "repeated_prompt_trace", "shared_prefix_trace", "static_generate",
]
