"""The port's serving CLI end to end on the CPU, and its refusal to fall back
to the CPU when CUDA was asked for but is missing."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.core.sod import SoDConfig
from repro_torch.kernels import ref
from repro_torch.launch import serve

ARGS = ["--reduced", "--sod", "tiled_csc", "--density", "0.3", "--batch", "2",
        "--prompt-len", "16", "--gen", "4"]
KEYS = {"arch", "device", "batch", "prompt_len", "generated", "prefill_s",
        "warmup_s", "steady_tok_per_s", "sample", "logits_finite",
        "kernel_launches", "weight_bytes"}


def test_cli_runs_on_cpu_and_prints_summary():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *ARGS,
         "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env, check=True)
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert KEYS <= set(summary)
    assert summary["device"] == "cpu" and summary["generated"] == 4
    assert summary["logits_finite"] is True
    assert len(summary["sample"]) == 4
    # no CUDA kernel runs on the CPU: the wrappers take the plain version
    assert summary["kernel_launches"] == {"sod_matmul": 0, "block_matmul": 0}
    wb = summary["weight_bytes"]
    assert 0 < wb["compressed"] < wb["dense"]


def test_every_projection_goes_through_the_wrapper(monkeypatch):
    """2 layers × 7 projections × (prefill + 4 decode steps) packed matmuls,
    each one call of the sod_matmul wrapper (its CPU path here)."""
    calls = []
    plain = ref.sod_matmul_ref

    def counting(*a, **kw):
        calls.append(a[1].shape)
        return plain(*a, **kw)

    monkeypatch.setattr(ref, "sod_matmul_ref", counting)
    summary = serve.main([*ARGS, "--device", "cpu"])
    assert len(calls) == 2 * 7 * (1 + 4)
    assert summary["kernel_launches"] == {"sod_matmul": 0, "block_matmul": 0}


def test_dense_serve_runs(capsys):
    summary = serve.main(["--reduced", "--batch", "2", "--prompt-len", "8",
                          "--gen", "2", "--device", "cpu"])
    assert summary["weight_bytes"]["compressed"] == summary["weight_bytes"]["dense"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary


def test_cuda_requested_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(ARGS)


@pytest.mark.parametrize("kw", [{"prune_method": "nm"}, {"qmode": "int4"}])
def test_unported_modes_raise(kw):
    """nm pruning is not ported yet; every qmode of the reference is, and an
    unknown one is rejected as the reference rejects it."""
    if "qmode" in kw:
        with pytest.raises(ValueError, match="unknown SoD qmode"):
            SoDConfig(**{"mode": "tiled_csc", **kw})
        assert SoDConfig(mode="tiled_csc", qmode="codebook").qmode == "codebook"
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        SoDConfig(**{"mode": "tiled_csc", **kw})
