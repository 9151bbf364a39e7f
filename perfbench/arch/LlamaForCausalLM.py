"""LlamaForCausalLM (Yi-34B's published architecture): RMSNorm, rotary
position embedding, grouped-query attention and a SwiGLU MLP, with no
biases and an untied head.  The dense decoder of
:mod:`perfbench.harness.dense` computes exactly this."""
from perfbench.harness.dense import Reference, draw_params, port_config  # noqa: F401
