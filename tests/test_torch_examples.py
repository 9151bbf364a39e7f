"""The port's twins of three examples, run on the CPU.

``examples/torch_quickstart.py``, ``torch_serve_decode.py`` and
``torch_train_sparse_lm.py`` each run their ``main`` with ``--device
cpu`` (the kernels' plain versions) at their reduced arguments; each
summary must be finite, the quickstart's product within the reference's
gate (max |err| < 1e-3) and its pack's bytes equal to the reference's
``pack_tiled_csc`` of the same numpy matrix.  Without a card and without
``--device cpu`` each twin raises.
"""
import importlib.util
import math
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import pruning as jpruning

ROOT = pathlib.Path(__file__).resolve().parents[1]
TWINS = ("torch_quickstart", "torch_serve_decode", "torch_train_sparse_lm",
         "torch_sod_fsdp_demo")


@pytest.fixture(autouse=True)
def _setup(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    from repro_torch.kernels import autotune
    autotune.set_cache(None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    autotune.set_cache(None)


def _twin(name: str, monkeypatch):
    spec = importlib.util.spec_from_file_location(f"_twin_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_on_the_cpu(monkeypatch):
    qs = _twin("torch_quickstart", monkeypatch)
    out = qs.main(["--device", "cpu"])
    assert out["max_abs_err"] < qs.TOL and math.isfinite(out["loss"])
    assert abs(out["density"] - 0.3) < 1e-3
    w = jpruning.magnitude_prune(jnp.asarray(qs.weight(0)), 0.3)
    ref = jformats.pack_tiled_csc(w, tile=(128, 128))
    assert (out["dense_bytes"], out["compressed_bytes"], out["compression_ratio"]) == (
        ref.nbytes_dense(), ref.nbytes_compressed(), ref.compression_ratio())
    assert out["density"] == jformats.density(np.asarray(w))
    stats = out["model_bytes"]
    assert stats["compressed"] < stats["dense"]
    assert out["kernel_launches"] == 0
    assert set(out["kernel_dispatch"]) == {"cuda_fused[forced]", "torch_oracle[prior]"}


def test_serve_decode_on_the_cpu(monkeypatch):
    out = _twin("torch_serve_decode", monkeypatch).main(["--device", "cpu"])
    assert list(out) == ["dense", "sod", "hybrid", "engine"]
    for run, summary in out.items():
        assert summary["logits_finite"], run
    assert out["dense"]["kernel_dispatch"] == {} and out["hybrid"]["kernel_dispatch"] == {}
    assert np.asarray(out["sod"]["generated_ids"]).shape == (4, 16)
    eng = out["engine"]
    assert eng["completed"] == 8 and set(eng["tokens"]) == {r.rid for r in eng["trace"]}
    assert set(eng["kernel_dispatch"]) == {"torch_oracle[prior]"}


def test_train_sparse_lm_smoke_on_the_cpu(monkeypatch, tmp_path):
    out = _twin("torch_train_sparse_lm", monkeypatch).main(
        ["--smoke", "--steps", "3", "--device", "cpu"])
    assert out["steps"] == 3 and "state" not in out
    assert all(map(math.isfinite, out["losses"] + out["grad_norms"]))
    assert out["arch"] == "xlstm-125m-smoke"
    assert out["kernel_dispatch"] == {"torch_oracle[prior]": out["kernel_dispatch"][
        "torch_oracle[prior]"]}
    kept = _twin("torch_train_sparse_lm", monkeypatch).main(
        ["--steps", "1", "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")])
    assert kept["steps"] == 1 and any((tmp_path / "ck").iterdir())


def test_sod_fsdp_demo_on_the_cpu(monkeypatch):
    """Eight CPU ranks: the compressed all-gather product within the
    reference demo's float32 error, each rank receiving the compressed
    payload less its own quarter, the body's dispatch mesh-qualified, and
    the top-k mean's relative error below 1 (the reference prints it)."""
    demo = _twin("torch_sod_fsdp_demo", monkeypatch)
    out = demo.main(["--device", "cpu"])
    assert len(out["ranks"]) == 8
    for r in out["ranks"]:
        assert r["max_abs_err"] < 1e-3 and r["device"] == "cpu"
        payload = r["payload_bytes"]
        assert r["resident_bytes"] == payload // 4
        assert r["gathered_bytes"] == payload - payload // 4
        assert r["dispatched"] and all("mesh=data=4,model=2|gather=data" in line
                                       for line in r["dispatched"])
        assert 0 < r["grad_rel_err"] < 1 and math.isfinite(r["residual_sum"])


@pytest.mark.parametrize("name", TWINS)
def test_twins_refuse_to_fall_back_to_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _twin(name, monkeypatch).main([])
