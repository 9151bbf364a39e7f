"""The port's quantized value storage (``qmode`` int8, fp8, codebook) against
the JAX package's, on the CPU: packing and its side band, ``to_dense``, byte
accounting, the plain matmuls and decompression in every qmode (held against
the jnp oracle and the Pallas kernels in interpret mode), the reduced llama
served from quantized weights, and the serve CLI's ``--quantize``.  The CUDA
kernels themselves are held against their plain versions in
tests/test_torch_cuda.py.

Tolerances: packed buffers (codes, rows, ids, scales, codebooks) and dense
matrices are compared exactly.  One matmul: float32 on both sides, sums in
different orders, within 1e-5 of the largest output.  A served model's
logits: within 1e-4 relative (tests/test_torch_model.py's bound), and equal
greedy tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import formats as jformats
from repro.core import pruning as jpruning
from repro.core import sod as jsod
from repro.data.pipeline import SyntheticLMData as JData
from repro.kernels import ops as jops
from repro.kernels.block_matmul import block_matmul_pallas
from repro.kernels.decompress import decompress_pallas
from repro.kernels.sod_matmul import sod_matmul_pallas
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models.model import LM as JLM
from repro_torch import configs
from repro_torch.core import formats, sod
from repro_torch.interop import (block_csr_from_numpy, params_from_numpy,
                                 tiled_csc_from_numpy, to_torch)
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, steps
from repro_torch.models.model import LM

QMODES = ("int8", "fp8", "codebook")
DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
MATMUL_TOL = 1e-5
SERVE_TOL = 1e-4


def _weight(shape, density, dtype="float32", seed=0, fmt="tiled_csc", tile=(128, 128),
            br=8):
    """A pruned weight both packages pack: magnitude sparsity for TiledCSC,
    block-pruned by the JAX package for BlockCSR (one slice at a time)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    if fmt == "tiled_csc":
        w[rng.random(shape) >= density] = 0.0
    else:
        flat = w.reshape((-1,) + tuple(shape[-2:]))
        w = np.stack([np.asarray(jpruning.block_prune(jnp.asarray(m), density,
                                                      (br, tile[1])))
                      for m in flat]).reshape(shape)
    if len(shape) == 2 and shape[0] >= 256:
        w[:128, :128] = 0.0          # an empty tile: its scale is 1.0
    return w.astype(DTYPES[dtype])


def _pack(fmt, pkg, w, tile, qmode, br=8):
    if pkg == "jax":
        w = jnp.asarray(w)
        if fmt == "tiled_csc":
            return jformats.pack_tiled_csc(w, tile=tile, qmode=qmode)
        return jformats.pack_block_csr(w, tile=tile, br=br, qmode=qmode)
    w = to_torch(w, "cpu")
    if fmt == "tiled_csc":
        return formats.pack_tiled_csc(w, tile=tile, qmode=qmode)
    return formats.pack_block_csr(w, tile=tile, br=br, qmode=qmode)


def _bits(a) -> np.ndarray:
    """A buffer as comparable numpy: fp8 through its bytes, bf16 widened."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float8_e4m3fn:
            return a.view(torch.uint8).numpy()
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return a.view(np.uint8)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _fields(fmt):
    if fmt == "tiled_csc":
        return ("vals", "rows", "scale", "codebook")
    return ("block_vals", "block_ids", "tile_nnz", "scale", "codebook")


def _assert_packed_equal(tp, jp, fmt):
    assert tp.qmode == jp.qmode and tp.shape == tuple(jp.shape)
    for name in _fields(fmt):
        t, j = getattr(tp, name), getattr(jp, name)
        assert (t is None) == (j is None), name
        if t is not None:
            assert tuple(t.shape) == tuple(j.shape), name
            np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=name)


def _carry(jp, fmt):
    side = dict(scale=jp.scale, codebook=jp.codebook, qmode=jp.qmode)
    if fmt == "tiled_csc":
        return tiled_csc_from_numpy(np.asarray(jp.vals), np.asarray(jp.rows),
                                    jp.shape, jp.tile, device="cpu", **side)
    return block_csr_from_numpy(np.asarray(jp.block_vals), np.asarray(jp.block_ids),
                                np.asarray(jp.tile_nnz), jp.shape, jp.tile, jp.br,
                                device="cpu", **side)


PACK_CASES = [
    ((256, 256), (128, 128), 0.3, "float32"),
    ((300, 260), (128, 128), 0.4, "bfloat16"),       # ragged
    ((200, 130), (64, 128), 0.3, "float32"),
    ((2, 3, 192, 136), (128, 128), 0.3, "float32"),  # stacked: per-slice side band
    ((3, 256, 128), (128, 128), 0.2, "bfloat16"),
]


# ---------------------------------------------------------------------------
# packing, to_dense, bytes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("qmode", QMODES)
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
@pytest.mark.parametrize("shape,tile,density,dtype", PACK_CASES)
def test_quantized_pack_equal(shape, tile, density, dtype, fmt, qmode):
    w = _weight(shape, density, dtype, seed=len(shape) + shape[-1], fmt=fmt,
                tile=tile)
    jp = _pack(fmt, "jax", w, tile, qmode)
    tp = _pack(fmt, "torch", w, tile, qmode)
    _assert_packed_equal(tp, jp, fmt)
    assert tp.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
                        "codebook": torch.int8}[qmode]
    dense = tp.to_dense()
    assert dense.dtype == torch.float32 and tuple(dense.shape) == shape
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jp.to_dense()))
    assert tp.nbytes_compressed() == jp.nbytes_compressed()
    assert tp.nbytes_compressed() < _pack(fmt, "torch", w, tile, "none").nbytes_compressed()
    # the carried reference pack is the port's pack
    _assert_packed_equal(_carry(jp, fmt), jp, fmt)
    if tp.lead:   # each slice carries its own scales / codebook
        first = tp.layer(0)
        while first.lead:
            first = first.layer(0)
        flat = np.asarray(jp.to_dense()).reshape((-1,) + shape[-2:])
        np.testing.assert_array_equal(first.to_dense().numpy(), flat[0])
        if qmode == "codebook":
            assert tuple(first.codebook.shape) == (formats.CODEBOOK_SIZE,)
        else:
            assert tuple(first.scale.shape) == tuple(first.grid)


@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
def test_dequantize_and_quantize_packed(fmt):
    w = _weight((256, 256), 0.3, seed=3, fmt=fmt)
    p = _pack(fmt, "torch", w, (128, 128), "none")
    assert formats.quantize_packed(p, "none") is p
    q = formats.quantize_packed(p, "int8")
    assert formats.quantize_packed(q, "int8") is q
    with pytest.raises(ValueError, match="already quantized"):
        formats.quantize_packed(q, "codebook")
    with pytest.raises(ValueError, match="unknown qmode"):
        formats.quantize_packed(p, "int4")
    d = q.dequantize()
    assert d.qmode == "none" and d.dtype == torch.float32 and d.scale is None
    assert torch.equal(d.to_dense(), q.to_dense())


@pytest.mark.parametrize("case", ["spread", "few_values", "all_zero", "bf16"])
def test_fit_codebook_equal(case):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 48)).astype(np.float32)
    if case == "few_values":        # collapsed quantiles
        x = rng.choice(np.float32([-1.5, 0.25, 2.0]), size=(64, 48))
    elif case == "all_zero":
        x = np.zeros((8, 8), np.float32)
    elif case == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    x[rng.random(x.shape) < 0.5] = 0
    for ncodes in (16, 4):
        np.testing.assert_array_equal(formats._fit_codebook(x, ncodes),
                                      jformats._fit_codebook(x, ncodes))


def test_qvalue_bits_and_constants():
    for qmode in ("none", *QMODES):
        assert formats.qvalue_bits(qmode) == jformats.qvalue_bits(qmode)
    assert formats.qvalue_bits("codebook", 128) == jformats.qvalue_bits("codebook", 128)
    assert formats.QMODES == jformats.QMODES
    assert formats.CODEBOOK_SIZE == jformats.CODEBOOK_SIZE
    assert formats.fp8_dtype() == torch.float8_e4m3fn


def test_to_torch_carries_fp8_bits():
    a = np.asarray(jnp.asarray(np.linspace(-448, 448, 301, dtype=np.float32))
                   .astype(jnp.float8_e4m3fn))
    t = to_torch(a, "cpu")
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(t.view(torch.uint8).numpy(), a.view(np.uint8))
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


# ---------------------------------------------------------------------------
# the plain matmuls and decompression against the reference
# ---------------------------------------------------------------------------
MATMUL_CASES = [((256, 256), 8, 0.3, (128, 128)), ((300, 260), 13, 0.4, (128, 128))]


def _pad(x, rows, cols):
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])))


def _assert_close(y, yr):
    y, yr = np.asarray(y, np.float32), np.asarray(yr, np.float32)
    assert y.shape == yr.shape
    assert np.abs(y - yr).max() <= MATMUL_TOL * np.abs(yr).max()


@pytest.mark.parametrize("qmode", QMODES)
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
@pytest.mark.parametrize("kn,m,density,tile", MATMUL_CASES)
def test_quantized_matmul_matches_reference(kn, m, density, tile, fmt, qmode):
    """The port's plain matmul (``ops.sod_matmul`` on a CPU tensor) against
    the reference's ``ops.sod_matmul`` (jnp oracle) and its Pallas kernel in
    interpret mode, on the same quantized pack."""
    w = _weight(kn, density, seed=m, fmt=fmt, tile=tile)
    x = np.random.default_rng(m + 1).standard_normal((m, kn[0])).astype(np.float32)
    jp = _pack(fmt, "jax", w, tile, qmode)
    y = ops.sod_matmul(to_torch(x, "cpu"), _carry(jp, fmt))
    assert y.dtype == torch.float32 and tuple(y.shape) == (m, kn[1])
    _assert_close(y.numpy(), jops.sod_matmul(jnp.asarray(x), jp))
    kt = jp.grid[0]
    xp = jnp.asarray(_pad(x, -(-m // 8) * 8, kt * tile[0]))
    kernel = sod_matmul_pallas if fmt == "tiled_csc" else block_matmul_pallas
    yp = np.asarray(kernel(xp, jp, bm=8, interpret=True))[:m, :kn[1]]
    _assert_close(y.numpy(), yp)


@pytest.mark.parametrize("qmode", QMODES)
@pytest.mark.parametrize("shape,tile,density", [
    ((256, 256), (128, 128), 0.3), ((300, 260), (128, 128), 0.4),
    ((200, 130), (64, 128), 0.9)])
def test_quantized_decompress_equal(shape, tile, density, qmode):
    """``ops.decompress`` of a quantized TiledCSC is float32 and bit-equal to
    the reference's Pallas decompression kernel in interpret mode."""
    w = _weight(shape, density, seed=shape[0], tile=tile)
    jp = _pack("tiled_csc", "jax", w, tile, qmode)
    d = ops.decompress(_carry(jp, "tiled_csc"))
    assert d.dtype == torch.float32 and tuple(d.shape) == shape
    dj = np.asarray(decompress_pallas(jp, interpret=True))[:shape[0], :shape[1]]
    assert dj.dtype == np.float32
    np.testing.assert_array_equal(d.numpy(), dj)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jops.decompress(jp)))
    db = ref.decompress_tiled_ref(_carry(jp, "tiled_csc"), torch.bfloat16)
    assert torch.equal(db, d.to(torch.bfloat16))


@pytest.mark.parametrize("qmode", QMODES)
def test_quantized_block_decompress_equal(qmode):
    w = _weight((300, 260), 0.3, seed=5, fmt="block_csr")
    jp = _pack("block_csr", "jax", w, (128, 128), qmode)
    d = ops.decompress(_carry(jp, "block_csr"))
    assert d.dtype == torch.float32
    np.testing.assert_array_equal(d.numpy(), np.asarray(jops.decompress(jp)))


# ---------------------------------------------------------------------------
# the served model and the CLI
# ---------------------------------------------------------------------------
B, S, GEN = 2, 16, 4
SERVED = [("tiled_csc", q) for q in QMODES] + [("block_csr", q) for q in QMODES]


@pytest.fixture(scope="module", params=SERVED, ids=lambda p: f"{p[0]}-{p[1]}")
def served(request):
    """Both packages' prefill + GEN greedy decode steps of the reduced llama
    in float32 with quantized weights, on the same weights and tokens."""
    fmt, qmode = request.param
    kw = dict(mode=fmt, density=0.3, min_dim=64, qmode=qmode,
              prune_method="block" if fmt == "block_csr" else "magnitude")
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b")).with_(
        dtype="float32", sod=jsod.SoDConfig(**kw))
    tcfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        dtype="float32", sod=sod.SoDConfig(**kw))
    jparams = JLM(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.asarray(JData(jcfg, B, S, seed=0).batch(0)["tokens"])

    jmodel = JLM(jcfg)
    jp = jsod.sodify_params(jparams, jcfg.sod)
    last, cache, pos0 = jserve.prefill_cache(
        jmodel, jp, {"tokens": jnp.asarray(tokens)}, S + GEN)
    jout = {"prefill": np.asarray(last), "tokens": []}
    decode = jax.jit(jsteps.make_decode_step(jmodel))
    tok = jnp.argmax(last, axis=-1).reshape(B, 1)
    for t in range(GEN):
        nxt, _, cache = decode(jp, cache, tok, jnp.asarray(pos0 + t, jnp.int32))
        tok = nxt.reshape(B, 1)
        jout["tokens"].append(np.asarray(nxt))

    tmodel = LM(tcfg)
    tp = sod.sodify_params(params_from_numpy(np_params, tcfg, device="cpu"),
                           tcfg.sod)
    with torch.inference_mode():
        last, cache, pos0 = serve.prefill_cache(
            tmodel, tp, to_torch(tokens, "cpu").long(), S + GEN)
        tout = {"prefill": last.numpy(), "tokens": []}
        decode = steps.make_decode_step(tmodel)
        tok = last.argmax(dim=-1).reshape(B, 1)
        for t in range(GEN):
            nxt, _, cache = decode(tp, cache, tok, pos0 + t)
            tok = nxt.reshape(B, 1)
            tout["tokens"].append(nxt.numpy())
    return {"fmt": fmt, "jax": jout, "torch": tout, "jparams": jp, "tparams": tp}


def test_served_prefill_logits_match(served):
    t, j = served["torch"]["prefill"], served["jax"]["prefill"]
    np.testing.assert_allclose(t, j, rtol=SERVE_TOL,
                               atol=SERVE_TOL * np.abs(j).max())


def test_served_greedy_tokens_equal(served):
    np.testing.assert_array_equal(np.stack(served["torch"]["tokens"]),
                                  np.stack(served["jax"]["tokens"]))


def test_served_packs_and_bytes_equal(served):
    fmt, jp, tp = served["fmt"], served["jparams"], served["tparams"]
    names = [("attn", n) for n in ("wq", "wk", "wv", "wo")] + \
        [("mlp", n) for n in ("w_gate", "w_up", "w_down")]
    for i, layer in enumerate(tp["layers"]):
        for group, name in names:
            tw, jw = layer[group][name], jp["blocks"][group][name]
            assert tw.lead == () and tw.qmode == jw.qmode
            for field in _fields(fmt):
                t, j = getattr(tw, field), getattr(jw, field)
                assert (t is None) == (j is None)
                if t is not None:
                    np.testing.assert_array_equal(_bits(t), _bits(np.asarray(j)[i, 0]))
    tb, jb = sod.tree_weight_bytes(tp), jsod.tree_weight_bytes(jp)
    assert tb == jb                     # compressed, dense and their ratio


@pytest.mark.parametrize("fmt,qmode", [("tiled_csc", "int8"), ("block_csr", "fp8"),
                                       ("tiled_csc", "codebook")])
def test_cli_quantize_on_cpu(fmt, qmode):
    summary = serve.main(["--reduced", "--sod", fmt, "--density", "0.3",
                          "--quantize", qmode, "--batch", "2", "--prompt-len", "8",
                          "--gen", "2", "--device", "cpu"])
    assert summary["logits_finite"] and len(summary["sample"]) == 2
    assert summary["kernel_launches"] == {"sod_matmul": 0, "block_matmul": 0}
    plain = serve.main(["--reduced", "--sod", fmt, "--density", "0.3", "--batch",
                        "2", "--prompt-len", "8", "--gen", "2", "--device", "cpu"])
    assert summary["weight_bytes"]["compressed"] < plain["weight_bytes"]["compressed"]


@pytest.mark.parametrize("argv,message", [
    (["--quantize", "int8"], "--quantize requires Sparse-on-Dense packing"),
    (["--quantize", "auto"], "--quantize requires Sparse-on-Dense packing"),
    (["--sod", "tiled_csc", "--quantize", "auto"], "--quantize auto needs the planner"),
])
def test_cli_quantize_errors_as_reference(argv, message, capsys):
    for main in (jserve.main, serve.main):
        with pytest.raises(SystemExit) as exc:
            main(["--reduced", *argv])
        assert exc.value.code == 2
        assert message in capsys.readouterr().err


def test_prepared_weights_are_served_as_given():
    """``serve.main(prepared=...)`` serves the caller's weights: the same
    summary as building them itself from the same flags."""
    argv = ["--reduced", "--sod", "tiled_csc", "--quantize", "int8", "--batch", "2",
            "--prompt-len", "8", "--gen", "3", "--device", "cpu"]
    cfg = dataclasses.replace(configs.reduced(configs.get_config("llama3.2-1b")),
                              n_layers=1)
    prepared = serve.prepare(serve.parse_args(argv), cfg=cfg)
    assert len(prepared[1]["layers"]) == 1
    a = serve.main(argv, prepared=prepared)
    b = serve.main(argv, prepared=prepared)
    assert a["sample"] == b["sample"]
    assert a["weight_bytes"] == b["weight_bytes"]
    assert a["weight_bytes"] != serve.main(argv)["weight_bytes"]   # 1 layer, not 2
