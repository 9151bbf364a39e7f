"""The shared modules' leftovers against the JAX package.

``core.sod.expected_cap``, ``kernels.registry.static_density``,
``all_impls`` and ``dispatch_summary``, and ``kernels.ref``'s
``decompress_block_ref`` and ``dense_matmul_ref``.  Integers, densities and
summary lines exactly; the float32 oracles within atol / rtol 1e-6 (the same
products, summed by another library), a bf16 output within one bf16 step
(rtol 2**-7).
"""
import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import sod as jsod
from repro.kernels import ref as jref
from repro.kernels import registry as jregistry
from repro_torch.core import formats, sod
from repro_torch.core.plan import QMODES
from repro_torch.kernels import autotune, ref, registry
from repro_torch.launch import serve

ATOL = RTOL = 1e-6
LINE = re.compile(r"^\w+\[(tuned|prior|forced)\] (tiled_csc|block_csr|dense) "
                  r"m=\d+ k=\d+ n=\d+ (cpu|cuda)( params=\{.*\})?$")


@pytest.fixture(autouse=True)
def _tmp_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "tuning_cache.json"))
    autotune.set_cache(None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    autotune.set_cache(None)


def _sparse(shape, density: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    return np.where(rng.uniform(size=shape) < density, w, 0).astype(np.float32)


def test_expected_cap_equals_the_reference():
    for bk in (8, 16, 32, 64, 100, 128, 256):
        for d in np.linspace(0.0, 1.0, 41):
            assert sod.expected_cap(bk, float(d)) == jsod.expected_cap(bk, float(d))


@pytest.mark.parametrize("d", (0.05, 0.3, 0.6, 1.0))
def test_static_density_equals_the_reference(d):
    w = _sparse((256, 384), d, seed=int(d * 100))
    tw = torch.from_numpy(w)
    pairs = [(formats.pack_tiled_csc(tw), jformats.pack_tiled_csc(jnp.asarray(w))),
             (formats.pack_tiled_csc(tw, tile=(64, 128), cap=24),
              jformats.pack_tiled_csc(jnp.asarray(w), tile=(64, 128), cap=24)),
             (formats.pack_block_csr(tw), jformats.pack_block_csr(jnp.asarray(w))),
             (tw, jnp.asarray(w))]
    for ours, theirs in pairs:
        assert registry.static_density(ours) == jregistry.static_density(theirs)
    key = registry.problem_key(pairs[0][0], 4, backend="cpu")
    assert key.density == registry.static_density(pairs[0][0])


def test_all_impls_holds_every_choice():
    impls = registry.all_impls()
    assert impls == registry._REGISTRY and impls is not registry._REGISTRY
    w = formats.pack_tiled_csc(torch.from_numpy(_sparse((256, 256), 0.3, 0)))
    b = formats.pack_block_csr(torch.from_numpy(_sparse((256, 256), 0.3, 0)))
    chosen = set()
    for backend in registry.BACKENDS:
        for qmode in QMODES:
            for op in (w, b):
                key = dataclasses.replace(registry.problem_key(op, 4, backend=backend),
                                          qmode=qmode)
                chosen.add(registry.choose(key, note=False)[0].name)
        dense = registry.problem_key(torch.zeros(8, 8), 4, backend=backend)
        chosen.add(registry.choose(dense, note=False)[0].name)
    assert chosen <= impls.keys()
    assert chosen == {"cuda_fused", "cuda_block", "torch_oracle", "dense_ref"}


def test_dispatch_summary_has_the_reference_format():
    """The lines of a recorded serve run: the reference's formatter over the
    same log gives the same lines, each of the reference's shape."""
    with registry.record_dispatches() as log:
        serve.main(["--arch", "llama3.2-1b", "--reduced", "--sod", "tiled_csc",
                    "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                    "--gen", "2"])
    lines = registry.dispatch_summary(log)
    assert lines == jregistry.dispatch_summary(log)
    assert lines and len(lines) == len(set(lines)) < len(log)
    assert all(LINE.match(line) for line in lines), lines
    assert {line.split(" ")[0] for line in lines} == {"torch_oracle[prior]"}


@pytest.mark.parametrize("qmode", ["none", "int8"])
def test_block_and_dense_oracles_equal_the_reference(qmode):
    w = _sparse((200, 136), 0.3, seed=5)
    ours = formats.pack_block_csr(torch.from_numpy(w), tile=(64, 64), qmode=qmode)
    theirs = jformats.pack_block_csr(jnp.asarray(w), tile=(64, 64), qmode=qmode)
    np.testing.assert_allclose(ref.decompress_block_ref(ours).numpy(),
                               np.asarray(jref.decompress_block_ref(theirs)),
                               atol=ATOL, rtol=RTOL)
    x = np.random.default_rng(1).standard_normal((9, 200)).astype(np.float32)
    for out in (None, torch.bfloat16):
        got = ref.dense_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), out)
        want = jref.dense_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                     None if out is None else jnp.bfloat16)
        assert got.dtype == (torch.float32 if out is None else torch.bfloat16)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=ATOL if out is None else 2e-2,
                                   rtol=RTOL if out is None else 2**-7)
