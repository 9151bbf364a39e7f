"""The port's Checkpointer, mirroring ``tests/test_checkpoint.py``: round
trip, commit marker, async save, GC, cast to the template's dtype — plus
bf16 leaves stored through their bits and fp8 leaves as float16 values (no
``ml_dtypes``), packed containers, the reference's on-disk layout, and
checkpoints crossing between the packages both ways, every fp8 bit pattern
kept.  Round trips are bit-exact."""
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


# every e4m3fn bit pattern, NaNs and -0.0 included
_ALL_FP8 = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn)
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float8_e4m3fn: jnp.float8_e4m3fn, torch.int8: jnp.int8,
        torch.int32: jnp.int32}


def _leaf(dtype):
    if dtype == torch.float8_e4m3fn:
        return _ALL_FP8
    g = torch.Generator().manual_seed(5)
    if dtype in (torch.int8, torch.int32):
        return torch.randint(-128, 128, (7, 9), generator=g, dtype=dtype)
    return (torch.randn(7, 9, generator=g) * 3).to(dtype)


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("dtype", list(_JNP))
def test_port_checkpoint_restores_in_the_reference(tmp_path, dtype):
    """Fault C5: the reference casts a leaf by value into its template's
    dtype, so an fp8 leaf must be on disk as values, not bits; every
    pattern comes back."""
    x = _leaf(dtype)
    Checkpointer(tmp_path).save(3, {"x": x, "y": [x[:2]]})
    out = JCheckpointer(tmp_path).restore(
        3, {"x": jnp.zeros(x.shape, _JNP[dtype]), "y": [jnp.zeros(x[:2].shape, _JNP[dtype])]})
    for got, want in ((out["x"], x), (out["y"][0], x[:2])):
        got = np.asarray(got)
        assert got.dtype == _JNP[dtype] and got.shape == tuple(want.shape)
        bits = want.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[want.element_size()])
        np.testing.assert_array_equal(_bits(got), _bits(bits.numpy()))


def test_reference_fp8_leaf_restores_in_the_port(tmp_path):
    """The reference writes an fp8 leaf as numpy's ``|V1``; the port reads
    its bits."""
    bits = np.arange(256, dtype=np.uint8)
    JCheckpointer(tmp_path).save(2, {"c": jnp.asarray(bits.view(jnp.float8_e4m3fn))})
    out = Checkpointer(tmp_path).restore(
        2, {"c": torch.zeros(256, dtype=torch.float8_e4m3fn)})
    assert out["c"].dtype == torch.float8_e4m3fn
    assert torch.equal(out["c"].view(torch.uint8), torch.from_numpy(bits))


def test_old_uint8_fp8_checkpoint_restores_bit_exact(tmp_path):
    """The port's checkpoints before the repair hold an fp8 leaf as its
    uint8 bits under the dtype name ``float8_e4m3fn``."""
    step = tmp_path / "step_00000004"
    step.mkdir()
    np.save(step / "0.npy", _ALL_FP8.view(torch.uint8).numpy())
    (step / "MANIFEST.msgpack").write_bytes(msgpack.packb({"step": 4, "leaves": [
        {"name": "['c']", "index": 0, "shape": [256], "dtype": "float8_e4m3fn"}]}))
    (step / "COMMITTED").touch()
    out = Checkpointer(tmp_path).restore(
        4, {"c": torch.zeros(256, dtype=torch.float8_e4m3fn)})
    assert torch.equal(out["c"].view(torch.uint8), _ALL_FP8.view(torch.uint8))


def test_every_fp8_pattern_round_trips_in_the_port(tmp_path):
    """Saved as float16 values and cast back: every e4m3fn bit pattern,
    NaNs and -0.0 included, comes back bit for bit."""
    ck = Checkpointer(tmp_path)
    ck.save(5, {"c": _ALL_FP8, "l": [_ALL_FP8.reshape(16, 16)]})
    out = ck.restore(5, {"c": torch.zeros(256, dtype=torch.float8_e4m3fn),
                         "l": [torch.zeros(16, 16, dtype=torch.float8_e4m3fn)]})
    assert out["c"].dtype == out["l"][0].dtype == torch.float8_e4m3fn
    assert torch.equal(out["c"].view(torch.uint8), _ALL_FP8.view(torch.uint8))
    assert torch.equal(out["l"][0].view(torch.uint8).flatten(), _ALL_FP8.view(torch.uint8))


def test_fp8_leaf_is_float16_values_on_disk(tmp_path):
    Checkpointer(tmp_path).save(1, {"c": _ALL_FP8})
    arr = np.load(tmp_path / "step_00000001" / "0.npy")
    assert arr.dtype == np.float16 and arr.nbytes == 2 * 256
    np.testing.assert_array_equal(arr, _ALL_FP8.to(torch.float16).numpy())
