"""InternLM2ForCausalLM (InternLM2's published architecture): the
llama-style decoder, with q, k and v held as one fused ``wqkv`` matrix.
The fused matrix's products are those of three separate ones, which is how
the port holds them, so the dense decoder of
:mod:`perfbench.harness.dense` serves and checks it."""
from perfbench.harness.dense import Reference, draw_params, port_config  # noqa: F401
