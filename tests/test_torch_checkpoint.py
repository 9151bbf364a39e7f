"""The port's Checkpointer, mirroring ``tests/test_checkpoint.py``: round
trip, commit marker, async save, GC, cast to the template's dtype — plus
bf16 and fp8 leaves stored through their bits (no ``ml_dtypes``), packed
containers, the reference's on-disk layout, and a checkpoint written by the
JAX package restored by the port.  Round trips are bit-exact."""
import dataclasses
import pathlib

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro_torch.checkpoint import Checkpointer
from repro_torch.core.formats import pack_tiled_csc, quantize_packed
from repro_torch.core.tree import leaves_with_path


def _state(scale=1.0):
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4) * scale,
                   "b": torch.ones(4) * scale},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "m": {"w": torch.zeros(3, 4), "b": torch.zeros(4)}},
    }


def _zeros_like(tree):
    from repro_torch.core.tree import tree_map
    return tree_map(torch.zeros_like, tree)


def _assert_bit_equal(a, b):
    la, lb = list(leaves_with_path(a)), list(leaves_with_path(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path)
    state = _state()
    ck.save(3, state)
    _assert_bit_equal(ck.restore(3, _zeros_like(state)), state)


def test_async_save_then_wait(tmp_path):
    ck = Checkpointer(tmp_path)
    state = _state()
    ck.save(1, state, blocking=False)
    state["params"]["w"].add_(100.0)     # the host copy was taken at save
    ck.wait()
    assert ck.latest_step() == 1
    assert torch.equal(ck.restore(1, _state())["params"]["w"], _state()["params"]["w"])
    assert [h["step"] for h in ck.history] == [1] and ck.history[0]["write_s"] >= 0


def test_committed_marker_guards_partial(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(5, _state())
    bad = pathlib.Path(tmp_path) / "step_00000009"
    bad.mkdir()
    (bad / "MANIFEST.msgpack").write_bytes(b"junk")
    assert ck.latest_step() == 5
    with pytest.raises(FileNotFoundError):
        ck.restore(9, _state())


def test_gc_keeps_last_n(tmp_path):
    ck = Checkpointer(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _state(scale=s))
    assert ck.all_steps() == [3, 4]


def test_restore_casts_to_template_dtype(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": torch.ones(4, dtype=torch.float32)})
    out = ck.restore(1, {"w": torch.zeros(4, dtype=torch.bfloat16)})
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"].float(), torch.ones(4))


def test_restore_missing_leaf_raises(tmp_path):
    ck = Checkpointer(tmp_path)
    ck.save(1, {"w": torch.ones(4)})
    with pytest.raises(KeyError):
        ck.restore(1, {"w": torch.ones(4), "extra": torch.ones(2)})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_low_precision_round_trip_is_bit_exact(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(33, 17, generator=g) * 3).to(dtype)
    ck = Checkpointer(tmp_path)
    ck.save(2, {"x": x, "l": [x[:4], None]})
    out = ck.restore(2, {"x": torch.zeros_like(x), "l": [torch.zeros_like(x[:4]), None]})
    assert out["x"].dtype == dtype and out["l"][1] is None
    assert torch.equal(out["x"].view(torch.uint8), x.view(torch.uint8))
    manifest = msgpack.unpackb((tmp_path / "step_00000002" / "MANIFEST.msgpack").read_bytes())
    want = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn"}[dtype]
    assert {m["dtype"] for m in manifest["leaves"]} == {want}
    assert {p.name for p in (tmp_path / "step_00000002").iterdir()} == {
        "MANIFEST.msgpack", "COMMITTED", "0.npy", "1.npy"}


@pytest.mark.parametrize("qmode", ["none", "int8", "fp8", "codebook"])
def test_packed_containers_round_trip(tmp_path, qmode):
    g = torch.Generator().manual_seed(1)
    w = torch.randn(256, 160, generator=g)
    w = torch.where(torch.rand(256, 160, generator=g) < 0.3, w, 0.0).to(torch.bfloat16)
    p = quantize_packed(pack_tiled_csc(w), qmode)
    state = {"params": {"layers": [{"wq": p}]}}
    ck = Checkpointer(tmp_path)
    ck.save(0, state)
    template = {"params": {"layers": [{"wq": dataclasses.replace(
        p, vals=torch.zeros_like(p.vals), rows=torch.zeros_like(p.rows))}]}}
    out = ck.restore(0, template)
    _assert_bit_equal(out, state)
    assert out["params"]["layers"][0]["wq"].qmode == qmode


def test_restores_a_checkpoint_written_by_the_reference(tmp_path):
    """The same layout: a bf16 and an f32 leaf saved by the JAX package."""
    jstate = {"b": jnp.arange(5, dtype=jnp.bfloat16) / 3, "w": jnp.ones((2, 3))}
    JCheckpointer(tmp_path).save(4, jstate)
    out = Checkpointer(tmp_path).restore(
        4, {"b": torch.zeros(5, dtype=torch.bfloat16), "w": torch.zeros(2, 3)})
    assert torch.equal(out["b"].view(torch.int16),
                       torch.from_numpy(np.asarray(jstate["b"]).view(np.int16)))
    assert torch.equal(out["w"], torch.ones(2, 3))
