"""Shared fixtures of the harness's tests: the checkout on the path, and a
configuration and mixes small enough for the CPU."""
from __future__ import annotations

import copy
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the published shapes of a llama-style decoder, at widths a CPU test holds;
# every matrix is whole (8, 128) blocks, so both formats apply
TINY = {
    "source": "test", "architectures": ["LlamaForCausalLM"], "port_arch": "internlm2-1.8b",
    "hidden_size": 256,
    "intermediate_size": 512, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "vocab_size": 8192, "rope_theta": 1000000,
    "rms_norm_eps": 1e-05, "torch_dtype": "bfloat16",
    "sod": {"mode": "tiled_csc", "density": 0.3, "prune_method": "magnitude",
            "tile": [128, 128], "br": 8, "min_dim": 64},
}
BLOCK_SOD = {"mode": "block_csr", "density": 0.3, "prune_method": "block",
             "tile": [128, 128], "br": 8, "min_dim": 64}
CLOSED = {
    "kind": "closed_loop", "clients": 4, "cycle": 4,
    "engine": {"max_slots": 4, "page_size": 16, "max_len": 96},
    "prompt_len": {"median": 24, "sigma": 0.6, "min": 8, "max": 48},
    "output_len": {"median": 16, "sigma": 0.5, "min": 8, "max": 32},
    "check": {"requests": 3}, "profile": {"start": 0.3, "seconds": 0.3},
}
@pytest.fixture
def tiny_cfg():
    return {**copy.deepcopy(TINY), "name": "tiny_tiled_csc"}


@pytest.fixture
def tiny_block_cfg():
    return {**copy.deepcopy(TINY), "sod": dict(BLOCK_SOD), "name": "tiny_block_csr"}


@pytest.fixture
def closed_mix():
    return {**copy.deepcopy(CLOSED), "name": "tiny_closed"}


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.fixture
def cuda_absent():
    """A host without a card, or a skip (the refusal is what is tested)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
