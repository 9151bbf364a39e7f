"""Gradients of the port's ``ops.sod_matmul`` against the JAX package's.

One weight (300 x 260, ragged against 128 x 128 tiles), pruned and packed
by the JAX package in every qmode, is carried across; x is (16, 300), the
shapes of ``tests/test_autotune.py``'s VJP tests, and the loss is
``sum(y ** 2)``.  The port differentiates it two ways: through the kernels'
``autograd.Function`` (``impl="cuda"``, whose wrapper runs the plain
forward on a CPU tensor, and the analytical backward of
``kernels/vjp.py``) and through autograd over the plain version
(``impl="jnp"``, ``torch_oracle``).  Both are held against ``jax.grad`` of
the reference's jnp oracle (``impl="jnp"``) and of its custom VJP
(``impl="pallas"``, Pallas in interpret mode).

Tolerances: float32, atol 1e-4 / rtol 1e-4 (sums in another order); bf16
activations and values, atol 2e-2 / rtol 1e-3, as the reference's own VJP
tests; fp8 codes' gradients, rtol 2**-3 (the cast to e4m3 may round one
3-bit step apart).  Padding slots get exactly 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as jformats
from repro.core import pruning as jpruning
from repro.kernels import ops as jops
from repro_torch.interop import block_csr_from_numpy, tiled_csc_from_numpy, to_torch
from repro_torch.kernels import ops

KEY = jax.random.PRNGKey(0)
K, N, M = 300, 260, 16
QMODES = ("none", "int8", "fp8", "codebook")
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=1e-3)}


def _np(t):
    return np.asarray(t.detach().float()) if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _jax_pack(fmt, qmode, dtype, seed):
    w = jpruning.random_sparse(jax.random.fold_in(KEY, seed), (K, N), 0.3)
    if fmt == "block_csr":
        w = jpruning.block_prune(w, 0.3, block=(8, 128))
        p = jformats.pack_block_csr(w.astype(dtype), tile=(128, 128), br=8)
    else:
        p = jformats.pack_tiled_csc(w.astype(dtype), tile=(128, 128))
    return jformats.quantize_packed(p, qmode) if qmode != "none" else p


def _carry(p):
    side = dict(scale=None if p.scale is None else np.asarray(p.scale),
                codebook=None if p.codebook is None else np.asarray(p.codebook),
                qmode=p.qmode)
    if isinstance(p, jformats.BlockCSR):
        return block_csr_from_numpy(np.asarray(p.block_vals), np.asarray(p.block_ids),
                                    np.asarray(p.tile_nnz), p.shape, p.tile, p.br,
                                    "cpu", **side)
    return tiled_csc_from_numpy(np.asarray(p.vals), np.asarray(p.rows), p.shape,
                                p.tile, "cpu", **side)


def _fields(p):
    vals = "block_vals" if hasattr(p, "block_vals") else "vals"
    return vals, "scale", "codebook"


def _jax_grads(x, p, impl):
    def loss(x, p):
        return jnp.sum(jops.sod_matmul(x, p, impl=impl).astype(jnp.float32) ** 2)

    gx, gp = jax.grad(loss, argnums=(0, 1), allow_int=True)(x, p)
    out = {"x": gx}
    for f in _fields(p):
        g = getattr(gp, f)
        if g is not None and g.dtype != jax.dtypes.float0:
            out[f] = g
    return out


def _torch_grads(x, p, impl):
    x = x.clone().requires_grad_(True)
    leaves = {f: getattr(p, f) for f in _fields(p)}
    leaves = {f: t.clone().requires_grad_(True) for f, t in leaves.items()
              if t is not None and t.is_floating_point()}
    w = dataclasses.replace(p, **leaves)
    y = ops.sod_matmul(x, w, impl=impl)
    (y.float() ** 2).sum().backward()
    return {"x": x.grad, **{f: t.grad for f, t in leaves.items()}}


def _check(got, want, qmode, dtype, where):
    assert set(got) == set(want), where
    for name in want:
        tol = TOL[dtype]
        if name == "vals" or name == "block_vals":
            if qmode == "fp8":
                tol = dict(atol=1e-6, rtol=2**-3)
        np.testing.assert_allclose(_np(got[name]), _np(want[name]),
                                   err_msg=f"{where}: d{name}", **tol)


@pytest.fixture(scope="module", params=[
    (fmt, q, "float32") for fmt in ("tiled_csc", "block_csr") for q in QMODES
] + [(fmt, "none", "bfloat16") for fmt in ("tiled_csc", "block_csr")],
    ids=lambda c: "-".join(c))
def case(request):
    fmt, qmode, dtype = request.param
    jp = _jax_pack(fmt, qmode, jnp.dtype(dtype), seed=5 if fmt == "tiled_csc" else 6)
    x = jax.random.normal(jax.random.fold_in(KEY, 3), (M, K)).astype(dtype)
    want = {impl: _jax_grads(x, jp, impl) for impl in ("jnp", "pallas")}
    return {"fmt": fmt, "qmode": qmode, "dtype": dtype, "jp": jp,
            "tp": _carry(jp), "x": to_torch(np.asarray(x), "cpu"), "want": want}


@pytest.mark.parametrize("impl", ["cuda", "jnp"])
@pytest.mark.parametrize("ref_impl", ["jnp", "pallas"])
def test_grads_match_reference(case, impl, ref_impl):
    got = _torch_grads(case["x"], case["tp"], impl)
    _check(got, case["want"][ref_impl], case["qmode"], case["dtype"],
           f"{case['fmt']}[{case['qmode']}] port {impl} vs reference {ref_impl}")


def test_padding_gets_exact_zero(case):
    p = case["tp"]
    got = _torch_grads(case["x"], p, "cuda")
    field = _fields(p)[0]
    if field not in got:       # integer codes get no gradient
        assert case["qmode"] in ("int8", "codebook")
        return
    pad = (p.rows < 0) if field == "vals" else (p.block_ids < 0)[..., None, None] \
        .expand(p.block_vals.shape)
    assert pad.any()
    assert (got[field].float()[pad] == 0).all()


def test_function_and_plain_autograd_agree(case):
    """The Function's analytical backward against autograd over the plain
    version, both in the port: the same float32 sums, so tight."""
    a = _torch_grads(case["x"], case["tp"], "cuda")
    b = _torch_grads(case["x"], case["tp"], "jnp")
    _check(a, b, case["qmode"], case["dtype"], "port cuda vs port jnp")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_operand_grads_match_reference(dtype):
    w = (jax.random.normal(jax.random.fold_in(KEY, 7), (K, N)) * K ** -0.5).astype(dtype)
    x = jax.random.normal(jax.random.fold_in(KEY, 8), (M, K)).astype(dtype)
    gx, gw = jax.grad(lambda x, w: jnp.sum(
        jops.sod_matmul(x, w).astype(jnp.float32) ** 2), argnums=(0, 1))(x, w)
    xt = to_torch(np.asarray(x), "cpu").requires_grad_(True)
    wt = to_torch(np.asarray(w), "cpu").requires_grad_(True)
    (ops.sod_matmul(xt, wt).float() ** 2).sum().backward()
    assert xt.grad.dtype == xt.dtype and wt.grad.dtype == wt.dtype
    np.testing.assert_allclose(_np(xt.grad), _np(gx), **TOL[dtype])
    np.testing.assert_allclose(_np(wt.grad), _np(gw), **TOL[dtype])


@pytest.mark.parametrize("xdtype,wdtype", [("bfloat16", "bfloat16"),
                                           ("bfloat16", "float32"),
                                           ("float32", "float32")])
def test_dense_matmul_backward_matches_reference(xdtype, wdtype):
    """f32 logits of a 16-bit product (the tied LM head's shape of call) and
    their cotangent back into both operands, as JAX transposes
    ``jnp.dot(..., preferred_element_type=float32)``."""
    x = jax.random.normal(jax.random.fold_in(KEY, 9), (M, 64)).astype(xdtype)
    w = jax.random.normal(jax.random.fold_in(KEY, 10), (64, 96)).astype(wdtype)
    t = jax.random.normal(jax.random.fold_in(KEY, 11), (M, 96))

    def loss(x, w):
        return jnp.sum(jnp.dot(x, w, preferred_element_type=jnp.float32) * t)

    gx, gw = jax.grad(loss, argnums=(0, 1))(x, w)
    xt = to_torch(np.asarray(x), "cpu").requires_grad_(True)
    wt = to_torch(np.asarray(w), "cpu").requires_grad_(True)
    y = ops.dense_matmul(xt, wt, torch.float32)
    assert y.dtype == torch.float32
    (y * to_torch(np.asarray(t), "cpu")).sum().backward()
    tol = TOL["bfloat16" if "bfloat16" in (xdtype, wdtype) else "float32"]
    np.testing.assert_allclose(_np(xt.grad), _np(gx), **tol)
    np.testing.assert_allclose(_np(wt.grad), _np(gw), **tol)
