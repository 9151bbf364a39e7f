"""The hand-written CUDA kernels (sod_matmul, block_matmul, decompress)
against their plain PyTorch versions, on the card.  Every test here needs an NVIDIA GPU and skips without one (a CUDA
kernel has no CPU mode); this file imports no JAX, so it runs on a machine
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance, as a fraction of the plain output's largest magnitude: 1e-4 in
float32 (sums in another order); 2**-7 in bf16 (the output may round one
bf16 step, 2**-8 relative, apart).  decompress is compared bit for bit, in
every qmode.
"""
import dataclasses

import pytest
import torch

from repro_torch.core.formats import pack_block_csr, pack_tiled_csc, quantize_packed
from repro_torch.core.pruning import block_prune, magnitude_prune
from repro_torch.kernels import block_matmul as bmm
from repro_torch.kernels import decompress as dk
from repro_torch.kernels import ref
from repro_torch.kernels import sod_matmul as sm

TOL = {torch.float32: 1e-4, torch.bfloat16: 2**-7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, k, n, m, dtype, density=0.3, tile=(128, 128), seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = magnitude_prune(torch.randn(k, n, generator=g, device=dev).to(dtype),
                        density)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    return x, pack_tiled_csc(w, tile=tile)


def _check(x, p, out_dtype=None):
    before = sm.launches
    y = sm.sod_matmul(x, p, out_dtype)
    torch.cuda.synchronize()
    assert sm.launches == before + 1
    yr = ref.sod_matmul_ref(x, p, out_dtype)
    assert y.shape == yr.shape and y.dtype == yr.dtype
    tol = TOL[torch.bfloat16 if torch.bfloat16 in (x.dtype, y.dtype)
              else torch.float32] * yr.float().abs().max().item()
    assert (y.float() - yr.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,m", [
    (2048, 2048, 4), (2048, 512, 4), (8192, 2048, 4),   # decode: split K
    (2048, 8192, 128), (2048, 512, 128),                # prefill
    (300, 260, 77), (129, 33, 1), (512, 384, 9),        # ragged edges
])
def test_kernel_matches_plain(cuda, k, n, m, dtype):
    _check(*_case(cuda, k, n, m, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.float32, torch.bfloat16)])
def test_kernel_out_dtype(cuda, dtype, out_dtype):
    x, p = _case(cuda, 1024, 640, 16, dtype)
    _check(x, p, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("density,tile", [(0.05, (128, 128)), (0.9, (128, 128)),
                                          (0.3, (64, 128)), (0.3, (128, 64))])
def test_kernel_caps_and_tiles(cuda, density, tile):
    """Small caps, caps above bk (every row stored), and other tiles."""
    _check(*_case(cuda, 640, 384, 24, torch.float32, density, tile))


@pytest.mark.cuda
def test_kernel_rejects_wide_tiles(cuda):
    x, p = _case(cuda, 512, 512, 4, torch.float32, tile=(256, 128))
    with pytest.raises(NotImplementedError):
        sm.sod_matmul(x, p)


@pytest.mark.cuda
def test_reduced_serve_launches_the_kernel(cuda):
    """Every packed projection of the serve path launches the kernel once:
    2 layers × 7 projections × (prefill + 4 decode steps)."""
    from repro_torch.launch import serve

    sm.launches = 0
    summary = serve.main(["--reduced", "--sod", "tiled_csc", "--density", "0.3",
                          "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert sm.launches == summary["kernel_launches"]["sod_matmul"] == 2 * 7 * 5
    assert summary["logits_finite"]


def _block_case(dev, k, n, m, dtype, density=0.3, tile=(128, 128), br=8, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = block_prune(torch.randn(k, n, generator=g, device=dev).to(dtype),
                    density, (br, tile[1]))
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    return x, pack_block_csr(w, tile=tile, br=br)


def _check_block(x, p, out_dtype=None):
    before = bmm.launches
    y = bmm.block_matmul(x, p, out_dtype)
    torch.cuda.synchronize()
    assert bmm.launches == before + 1
    yr = ref.block_matmul_ref(x, p, out_dtype)
    assert y.shape == yr.shape and y.dtype == yr.dtype
    tol = TOL[torch.bfloat16 if torch.bfloat16 in (x.dtype, y.dtype)
              else torch.float32] * yr.float().abs().max().item()
    assert (y.float() - yr.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,m", [
    (2048, 2048, 4), (2048, 512, 4), (8192, 2048, 4),   # decode: split K
    (2048, 8192, 128), (2048, 512, 128),                # prefill
    (300, 260, 77), (129, 33, 1), (512, 384, 9),        # ragged edges
])
def test_block_kernel_matches_plain(cuda, k, n, m, dtype):
    _check_block(*_block_case(cuda, k, n, m, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.float32, torch.bfloat16)])
def test_block_kernel_out_dtype(cuda, dtype, out_dtype):
    x, p = _block_case(cuda, 1024, 640, 16, dtype)
    _check_block(x, p, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("density,tile,br,bcap", [
    (0.05, (128, 128), 8, None), (1.0, (128, 128), 8, None),
    (0.3, (64, 128), 16, None), (0.3, (256, 64), 8, None),
    (0.5, (128, 128), 8, 3),          # explicit bcap: largest sub-blocks kept
    (0.3, (128, 128), 4, None),       # br % 8 != 0: rows walked one at a time
])
def test_block_kernel_caps_and_tiles(cuda, density, tile, br, bcap):
    x, p = _block_case(cuda, 640, 384, 24, torch.float32, density, tile, br)
    if bcap is not None:
        p = pack_block_csr(p.to_dense(), tile=tile, br=br, bcap=bcap)
    _check_block(x, p)


@pytest.mark.cuda
def test_block_kernel_skips_zero_tiles(cuda):
    """A zero macro-tile row (tile_nnz 0 there) at full size: the product
    still equals x @ w."""
    x, p = _block_case(cuda, 8192, 2048, 4, torch.float32)
    w = p.to_dense()
    w[2048:4096] = 0
    p = pack_block_csr(w)
    assert int(p.tile_nnz[16:32].count_nonzero()) == 0
    _check_block(x, p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,density,tile", [
    (2048, 2048, 0.3, (128, 128)), (2048, 8192, 0.3, (128, 128)),
    (300, 260, 0.4, (128, 128)), (200, 130, 0.9, (64, 128)),
    (129, 33, 0.05, (128, 128)),
])
def test_decompress_kernel_bit_equal(cuda, k, n, density, tile, dtype):
    _, p = _case(cuda, k, n, 1, dtype, density, tile)
    before = dk.launches
    d = dk.decompress(p)
    torch.cuda.synchronize()
    assert dk.launches == before + 1
    assert d.shape == (k, n) and d.dtype == dtype
    assert torch.equal(d, ref.decompress_tiled_ref(p))


@pytest.mark.cuda
def test_reduced_block_serve_launches_the_kernel(cuda):
    """Every packed projection of the block_csr serve launches the block
    kernel once: 2 layers × 7 projections × (prefill + 4 decode steps)."""
    from repro_torch.core.sod import SoDConfig
    from repro_torch.launch import serve

    bmm.launches = sm.launches = 0
    summary = serve.main(["--reduced", "--batch", "2", "--prompt-len", "16",
                          "--gen", "4"],
                         sod=SoDConfig(mode="block_csr", density=0.3,
                                       prune_method="block", min_dim=64))
    assert summary["kernel_launches"] == {"sod_matmul": 0, "block_matmul": 2 * 7 * 5}
    assert bmm.launches == 2 * 7 * 5 and sm.launches == 0
    assert summary["logits_finite"]


# ---------------------------------------------------------------------------
# quantized operands (qmode int8, fp8, codebook)
# ---------------------------------------------------------------------------
QMODES = ("int8", "fp8", "codebook")


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", QMODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,m", [
    (2048, 512, 4),          # decode: split K
    (1024, 640, 128),        # prefill-sized M
    (300, 260, 77),          # ragged edges
])
def test_quantized_kernel_matches_plain(cuda, k, n, m, dtype, qmode):
    x, p = _case(cuda, k, n, m, dtype)
    _check(x, quantize_packed(p, qmode))


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", QMODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,m", [(2048, 512, 4), (1024, 640, 128), (300, 260, 77)])
def test_quantized_block_kernel_matches_plain(cuda, k, n, m, dtype, qmode):
    x, p = _block_case(cuda, k, n, m, dtype)
    _check_block(x, quantize_packed(p, qmode))


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", QMODES)
def test_quantized_kernels_out_dtype(cuda, qmode):
    x, p = _case(cuda, 640, 384, 24, torch.bfloat16)
    _check(x, quantize_packed(p, qmode), torch.float32)
    x, p = _block_case(cuda, 640, 384, 24, torch.bfloat16)
    _check_block(x, quantize_packed(p, qmode), torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", QMODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,density,tile", [
    (2048, 2048, 0.3, (128, 128)), (300, 260, 0.4, (128, 128)),
    (200, 130, 0.9, (64, 128)),
])
def test_quantized_decompress_bit_equal(cuda, k, n, density, tile, dtype, qmode):
    """float32 by default (bit-equal to to_dense), and bf16 on request
    (bit-equal to to_dense cast to bf16)."""
    _, p = _case(cuda, k, n, 1, dtype, density, tile)
    q = quantize_packed(p, qmode)
    before = dk.launches
    d = dk.decompress(q)
    db = dk.decompress(q, torch.bfloat16)
    torch.cuda.synchronize()
    assert dk.launches == before + 2
    assert d.shape == (k, n) and d.dtype == torch.float32
    assert torch.equal(d, ref.decompress_tiled_ref(q))
    assert torch.equal(db, ref.decompress_tiled_ref(q, torch.bfloat16))


@pytest.mark.cuda
def test_quantized_wrappers_reject_bad_side_bands(cuda):
    x, p = _case(cuda, 512, 256, 4, torch.bfloat16)
    q = quantize_packed(p, "int8")
    for bad in (dataclasses.replace(q, scale=q.scale.double()),   # wrong dtype
                dataclasses.replace(q, scale=None)):              # missing
        with pytest.raises(TypeError):
            sm.sod_matmul(x, bad)
        with pytest.raises(TypeError):
            dk.decompress(bad)
    with pytest.raises(ValueError):                               # wrong shape
        sm.sod_matmul(x, dataclasses.replace(q, scale=q.scale[:1]))
    c = quantize_packed(p, "codebook")
    with pytest.raises(TypeError):
        sm.sod_matmul(x, dataclasses.replace(c, codebook=c.codebook.half()))
    with pytest.raises(ValueError):                               # > 128 entries
        sm.sod_matmul(x, dataclasses.replace(c, codebook=c.codebook.repeat(9)))
    xb, pb = _block_case(cuda, 512, 256, 4, torch.bfloat16)
    qb = quantize_packed(pb, "fp8")
    with pytest.raises(TypeError):
        bmm.block_matmul(xb, dataclasses.replace(qb, scale=qb.scale.bfloat16()))
    with pytest.raises(TypeError):     # fp8 qmode over int8 codes
        bmm.block_matmul(xb, dataclasses.replace(qb, block_vals=qb.block_vals.view(torch.int8)))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,qmode", [("tiled_csc", "int8"), ("tiled_csc", "codebook"),
                                       ("block_csr", "fp8")])
def test_reduced_quantized_serve_launches_the_kernel(cuda, fmt, qmode):
    """Every packed projection of a quantized serve launches its kernel once:
    2 layers × 7 projections × (prefill + 4 decode steps)."""
    from repro_torch.core.sod import SoDConfig
    from repro_torch.launch import serve

    bmm.launches = sm.launches = 0
    summary = serve.main(["--reduced", "--batch", "2", "--prompt-len", "16",
                          "--gen", "4"],
                         sod=SoDConfig(mode=fmt, density=0.3, min_dim=64, qmode=qmode,
                                       prune_method="block" if fmt == "block_csr"
                                       else "magnitude"))
    want = {"sod_matmul": 0, "block_matmul": 0}
    want["sod_matmul" if fmt == "tiled_csc" else "block_matmul"] = 2 * 7 * 5
    assert summary["kernel_launches"] == want
    assert (sm.launches, bmm.launches) == (want["sod_matmul"], want["block_matmul"])
    assert summary["logits_finite"]


# ---------------------------------------------------------------------------
# sod_matmul's ring of tile slabs and its split-K reduced inside the launch
# ---------------------------------------------------------------------------
ALL_QMODES = ("none", *QMODES)


def _operand(p, qmode):
    return p if qmode == "none" else quantize_packed(p, qmode)


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ALL_QMODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,one_split", [(128, 2048, True), (2048, 512, False),
                                           (8192, 2048, False)])
def test_decode_splits_every_qmode(cuda, k, n, one_split, dtype, qmode):
    """Decode (M = 4) with one K split (the sums go straight out) and with
    several (the last CTA to arrive sums the partials)."""
    x, p = _case(cuda, k, n, 4, dtype)
    q = _operand(p, qmode)
    assert (sm.plan_of(x, q).splits == 1) == one_split
    _check(x, q)


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ALL_QMODES)
@pytest.mark.parametrize("k,n,m", [(2048, 512, 4), (8192, 2048, 4), (2048, 2048, 128),
                                   (300, 260, 77)])
def test_two_calls_bit_equal(cuda, k, n, m, qmode):
    """Split-K sums in split order whichever CTA arrives last."""
    x, p = _case(cuda, k, n, m, torch.bfloat16)
    q = _operand(p, qmode)
    y1, y2 = sm.sod_matmul(x, q), sm.sod_matmul(x, q)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ALL_QMODES)
def test_stacked_layer_slice(cuda, qmode):
    """packed.layer(i) is a view into the stacked buffers, as the model
    passes it; a view at an offset a bulk copy cannot take raises."""
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    w = magnitude_prune(torch.randn(3, 2048, 512, generator=g, device=cuda), 0.3)
    stacked = _operand(pack_tiled_csc(w.bfloat16()), qmode)
    x = torch.randn(4, 2048, generator=g, device=cuda).bfloat16()
    for i in range(3):
        layer = stacked.layer(i)
        assert layer.vals.data_ptr() == stacked.vals.data_ptr() + i * layer.vals.nbytes
        _check(x, layer)
    layer = stacked.layer(1)
    flat = torch.empty(layer.vals.numel() + 1, dtype=layer.vals.dtype, device=cuda)
    off = flat[1:].view(layer.vals.shape)
    off.copy_(layer.vals)
    with pytest.raises(ValueError, match="aligned"):
        sm.sod_matmul(x, dataclasses.replace(layer, vals=off))


def _shape_sequence(dev):
    """Calls of different shapes (splits and output tiles) back to back."""
    cases = [(2048, 512, 4), (8192, 2048, 4), (2048, 8192, 4), (2048, 512, 4),
             (2048, 2048, 128), (300, 260, 77), (8192, 2048, 4)]
    return [_case(dev, k, n, m, torch.bfloat16, seed=i) for i, (k, n, m) in enumerate(cases)]


@pytest.mark.cuda
def test_back_to_back_shapes_one_stream(cuda):
    """No synchronisation between calls: each launch leaves its counters at
    0 for the next, whatever its shape."""
    cases = _shape_sequence(cuda)
    torch.cuda.synchronize()
    ys = [sm.sod_matmul(x, p) for x, p in cases]
    torch.cuda.synchronize()
    for (x, p), y in zip(cases, ys):
        yr = ref.sod_matmul_ref(x, p)
        assert (y.float() - yr.float()).abs().max().item() <= TOL[torch.bfloat16] * yr.float().abs().max().item()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not sm._counters[(cuda.index or 0, stream)].any()


@pytest.mark.cuda
def test_back_to_back_shapes_two_streams(cuda):
    """Two streams at once: each has its own counters."""
    cases = _shape_sequence(cuda)
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    ys = [[], []]
    for _ in range(3):
        for s, out in zip(streams, ys):
            with torch.cuda.stream(s):
                out.extend(sm.sod_matmul(x, p) for x, p in cases)
    torch.cuda.synchronize()
    want = [ref.sod_matmul_ref(x, p) for x, p in cases]
    for out in ys:
        for y, yr in zip(out, want * 3):
            assert (y.float() - yr.float()).abs().max().item() <= TOL[torch.bfloat16] * yr.float().abs().max().item()
    bufs = [sm._counters[(cuda.index or 0, s.cuda_stream)] for s in streams]
    assert bufs[0].data_ptr() != bufs[1].data_ptr()
    assert not any(b.any() for b in bufs)


# ---------------------------------------------------------------------------
# block_matmul's ring of stored slabs and its split-K reduced inside the launch
# ---------------------------------------------------------------------------
def _block_operand(dev, k, n, m, dtype, qmode, seed=0):
    x, p = _block_case(dev, k, n, m, dtype, seed=seed)
    return x, _operand(p, qmode)


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ALL_QMODES)
@pytest.mark.parametrize("k,n,m,split", [(2048, 512, 4, True), (8192, 2048, 4, True),
                                         (2048, 2048, 128, True), (300, 260, 77, None)])
def test_block_two_calls_bit_equal(cuda, k, n, m, split, qmode):
    """Split-K sums in split order whichever CTA arrives last."""
    x, q = _block_operand(cuda, k, n, m, torch.bfloat16, qmode)
    if split:
        assert bmm.plan_of(x, q).splits > 1
    y1, y2 = bmm.block_matmul(x, q), bmm.block_matmul(x, q)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ALL_QMODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_zero_tile_row_every_qmode(cuda, dtype, qmode):
    """A macro-tile row with tile_nnz == 0 issues no copy and takes no stage;
    the product still equals the plain version's."""
    x, p = _block_case(cuda, 8192, 2048, 4, dtype)
    w = p.to_dense()
    w[2048:4096] = 0
    p = _operand(pack_block_csr(w), qmode)
    assert int(p.tile_nnz[16:32].count_nonzero()) == 0
    _check_block(x, p)


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ALL_QMODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,m", [(300, 260, 77), (129, 33, 1), (1000, 200, 5),
                                   (2100, 700, 9)])
def test_block_ragged_every_qmode(cuda, k, n, m, dtype, qmode):
    _check_block(*_block_operand(cuda, k, n, m, dtype, qmode))


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ALL_QMODES)
@pytest.mark.parametrize("m,bm", [(1, 4), (4, 4), (5, 8), (8, 8), (9, 16), (17, 16),
                                  (77, 16), (128, 16), (300, 16)])
def test_block_m_blocks_every_qmode(cuda, m, bm, qmode):
    """M across the BM = 4 / 8 / 16 boundaries, and above 16 rows CTAs of
    M_GROUPS groups of 16 (ragged in the last group, and over several
    CTAs)."""
    x, q = _block_operand(cuda, 2048, 512, m, torch.bfloat16, qmode)
    plan = bmm.plan_of(x, q)
    assert plan.bm == bm
    assert plan.m_groups == (min(bmm.M_GROUPS, -(-m // 16)) if bm == 16 else 1)
    _check_block(x, q)


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ALL_QMODES)
@pytest.mark.parametrize("groups", [1, 2, 3, 4, 8])
def test_block_m_groups_every_qmode(cuda, groups, qmode, monkeypatch):
    """Groups of 16 rows a CTA can hold, from 1 to MAX_THREADS / 64 at
    bn = 128, ragged in the last group, over two CTAs."""
    monkeypatch.setattr(bmm, "M_GROUPS", groups)
    bmm.plan_launch.cache_clear()
    try:
        for m in (16 * groups + 11, 32 * groups - 5):
            x, q = _block_operand(cuda, 1024, 640, m, torch.float32, qmode)
            assert bmm.plan_of(x, q).m_groups == min(groups, -(-m // 16))
            _check_block(x, q)
    finally:
        bmm.plan_launch.cache_clear()


@pytest.mark.cuda
def test_block_and_sod_share_counters(cuda):
    """sod_matmul and block_matmul calls of different shapes back to back on
    one stream, with no synchronisation: they share one counter buffer, and
    each launch leaves its counters at 0 for the next."""
    cases = [(2048, 512, 4), (8192, 2048, 4), (2048, 8192, 4), (2048, 2048, 128),
             (300, 260, 77), (8192, 2048, 4)]
    calls = []
    for i, (k, n, m) in enumerate(cases):
        calls.append((sm.sod_matmul, ref.sod_matmul_ref,
                      *_case(cuda, k, n, m, torch.bfloat16, seed=i)))
        calls.append((bmm.block_matmul, ref.block_matmul_ref,
                      *_block_operand(cuda, k, n, m, torch.bfloat16,
                                      ALL_QMODES[i % 4], seed=i)))
    torch.cuda.synchronize()
    ys = [fn(x, p) for fn, _, x, p in calls]
    torch.cuda.synchronize()
    for (_, plain, x, p), y in zip(calls, ys):
        yr = plain(x, p)
        assert (y.float() - yr.float()).abs().max().item() <= \
            TOL[torch.bfloat16] * yr.float().abs().max().item()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    buf = sm._counters[(cuda.index or 0, stream)]
    need = max(p.grid[1] * -(-x.shape[0] // sm.m_block(x.shape[0])) for _, _, x, p in calls)
    need = max(need, *(p.grid[1] * -(-x.shape[0] // (plan.bm * plan.m_groups))
                       for _, _, x, p in calls[1::2] for plan in [bmm.plan_of(x, p)]))
    assert buf.numel() >= need and not buf.any()


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ALL_QMODES)
def test_block_stacked_layer_slice(cuda, qmode):
    """packed.layer(i) is a view into the stacked buffers, as the model
    passes it.  With 3 x 1 macro tiles and an odd bcap, the ids of layer 1
    start off a 16-byte boundary: the kernel's ids copy starts at the
    boundary below.  A view of block_vals at an offset a bulk copy cannot
    take raises."""
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    w = torch.randn(3, 384, 128, generator=g, device=cuda).bfloat16()
    w = torch.stack([block_prune(w[i], 0.4, (8, 128)) for i in range(3)])
    stacked = pack_block_csr(w)
    if stacked.bcap % 2 == 0:          # make the bcap odd: one more padding slot
        stacked = pack_block_csr(w, bcap=stacked.bcap + 1)
    stacked = _operand(stacked, qmode)
    x = torch.randn(4, 384, generator=g, device=cuda).bfloat16()
    assert any(stacked.layer(i).block_ids.data_ptr() % 16 for i in range(3))
    for i in range(3):
        _check_block(x, stacked.layer(i))
    layer = stacked.layer(1)
    flat = torch.empty(layer.block_vals.numel() + 1, dtype=layer.block_vals.dtype,
                       device=cuda)
    off = flat[1:].view(layer.block_vals.shape)
    off.copy_(layer.block_vals)
    with pytest.raises(ValueError, match="aligned"):
        bmm.block_matmul(x, dataclasses.replace(layer, block_vals=off))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
@pytest.mark.parametrize("x_dtype,w_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.float32, torch.bfloat16)])
def test_mixed_dtype_packed_on_card(cuda, fmt, x_dtype, w_dtype):
    """ops.sod_matmul promotes a packed operand of another dtype than x to
    f32 and casts the sums once to x's dtype, as on the CPU."""
    from repro_torch.kernels import ops

    make = _case if fmt == "tiled_csc" else _block_case
    x, p = make(cuda, 1024, 640, 4, w_dtype)
    x = x.to(x_dtype)
    y = ops.sod_matmul(x, p)
    torch.cuda.synchronize()
    assert y.dtype == x_dtype
    yr = (x.float() @ p.to_dense().float()).to(x_dtype)
    tol = TOL[torch.bfloat16] * yr.float().abs().max().item()
    assert (y.float() - yr.float()).abs().max().item() <= tol


# ---------------------------------------------------------------------------
# row invariance: a row's sums do not depend on the rows beside it, which the
# engine's equality with static serving needs (its decode runs max_slots rows,
# its prefill a bucket or a chunk of a prompt, static serving one request)
# ---------------------------------------------------------------------------
INVARIANT_M = (4, 8, 12, 16, 20, 40, 64, 128)   # 12, 20: 4 slots x (k + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ALL_QMODES)
@pytest.mark.parametrize("kernel", ["sod_matmul", "block_matmul"])
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)])
def test_row_alone_equals_row_in_batch(cuda, k, n, kernel, qmode):
    """One row of x computed alone equals the same row inside M rows, bit
    for bit, for every M of INVARIANT_M: at the path's projection shapes, in
    every qmode, in bf16."""
    make = _case if kernel == "sod_matmul" else _block_case
    fn = sm.sod_matmul if kernel == "sod_matmul" else bmm.block_matmul
    x, p = make(cuda, k, n, max(INVARIANT_M), torch.bfloat16)
    q = _operand(p, qmode)
    outs = {m: fn(x[:m].contiguous(), q) for m in INVARIANT_M}
    for row in (0, 3, 37, 127):
        alone = fn(x[row:row + 1].contiguous(), q)
        for m, y in outs.items():
            if row < m:
                assert torch.equal(y[row], alone[0]), (row, m)


# The dense family's shapes: K up to 36,864 (x staged one tile at a time,
# many K splits) and the untied heads at float32 out (N up to 92,544).
FAMILY_ROW_SHAPES = [(36864, 4608, None), (20480, 7168, None),
                     (2048, 92544, torch.float32), (7168, 64000, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ["none", "int8"])
@pytest.mark.parametrize("kernel", ["sod_matmul", "block_matmul"])
@pytest.mark.parametrize("k,n,out_dtype", FAMILY_ROW_SHAPES)
def test_row_alone_equals_row_in_batch_at_family_shapes(cuda, k, n, out_dtype, kernel,
                                                         qmode):
    """test_row_alone_equals_row_in_batch at gemma2's and yi's w_down and at
    internlm2's and yi's heads (float32 out), bf16 activations."""
    make = _case if kernel == "sod_matmul" else _block_case
    fn = sm.sod_matmul if kernel == "sod_matmul" else bmm.block_matmul
    x, p = make(cuda, k, n, max(INVARIANT_M), torch.bfloat16)
    q = _operand(p, qmode)
    del p
    outs = {m: fn(x[:m].contiguous(), q, out_dtype) for m in INVARIANT_M}
    for row in (0, 3, 37, 127):
        alone = fn(x[row:row + 1].contiguous(), q, out_dtype)
        for m, y in outs.items():
            if row < m:
                assert torch.equal(y[row], alone[0]), (row, m)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4608, 7168])
def test_rms_norm_rows_invariant_at_family_widths(cuda, d):
    """RMSNorm at gemma2's and yi's d_model in bf16: a row alone (static
    decode) has the bits of that row among the engine's rows (4 slots, 4 ×
    (k + 1) at verify, a prompt's bucket), and a prompt's rows keep their
    bits at its page bucket and in 16-row chunks."""
    from repro_torch.models import layers

    g = torch.Generator(device=cuda)
    g.manual_seed(9)
    x = torch.randn(max(INVARIANT_M), d, generator=g, device=cuda).bfloat16()
    gain = torch.randn(d, generator=g, device=cuda) * 0.1
    outs = {m: layers.rms_norm(x[:m], gain) for m in INVARIANT_M}
    for row in (0, 3, 11, 37, 127):
        alone = layers.rms_norm(x[row:row + 1], gain)[0]
        for m, y in outs.items():
            if row < m:
                assert torch.equal(y[row], alone), (row, m)
    prompt = layers.rms_norm(x[:40], gain)
    assert torch.equal(layers.rms_norm(x[:48], gain)[:40], prompt)
    for start in (0, 16, 32):
        chunk = layers.rms_norm(x[start:start + 16], gain)
        assert torch.equal(chunk[:min(16, 40 - start)], prompt[start:start + 16])


@pytest.mark.cuda
def test_norm_and_attention_rows_invariant_on_card(cuda):
    """At the shapes the engine compares with static serving, in bf16 at
    full width's head geometry: RMSNorm and cached decode attention give a
    row alone (static decode) the bits of that row among 4 (the engine's
    slots) over a longer cache (its pages), and RMSNorm gives a prompt's
    rows the same bits at the prompt's length, its page bucket and its
    16-row chunks.  torch's reductions and cuBLAS hold this at these
    shapes; the model does nothing else to hold it."""
    from repro_torch.models import attention as attn
    from repro_torch.models import layers

    g = torch.Generator(device=cuda)
    g.manual_seed(7)
    x = torch.randn(64, 2048, generator=g, device=cuda).bfloat16()
    gain = torch.randn(2048, generator=g, device=cuda) * 0.1
    four = layers.rms_norm(x[:4], gain)
    for row in range(4):
        assert torch.equal(layers.rms_norm(x[row:row + 1], gain)[0], four[row])
    prompt = layers.rms_norm(x[:40], gain)
    assert torch.equal(layers.rms_norm(x[:48], gain)[:40], prompt)
    for start in (0, 16, 32):
        chunk = layers.rms_norm(x[start:start + 16], gain)
        assert torch.equal(chunk[:min(16, 40 - start)], prompt[start:start + 16])
    spec = attn.AttnSpec(n_heads=32, n_kv_heads=8, head_dim=64)
    k = torch.randn(4, 80, 8, 64, generator=g, device=cuda).bfloat16()
    v = torch.randn(4, 80, 8, 64, generator=g, device=cuda).bfloat16()
    q = torch.randn(4, 1, 32, 64, generator=g, device=cuda).bfloat16()
    pos = torch.tensor([40, 51, 63, 70], device=cuda)
    batch = attn._attend_cached(q, k, v, pos, spec, None)
    for row in range(4):
        p = int(pos[row])
        alone = attn._attend_cached(q[row:row + 1], k[row:row + 1, :p + 9],
                                    v[row:row + 1, :p + 9], p, spec, None)
        assert torch.equal(batch[row], alone[0])


@pytest.mark.cuda
def test_prefill_rows_equal_across_bucket_and_chunks_on_card(cuda):
    """At full width's head geometry in bf16: a 40-token prompt's attention
    rows are the same bits attended alone, padded to its 48-token page
    bucket, and chunk by chunk (16 tokens) through the pool.  The
    projections see small multiples of 1/4, so their sums are exact and
    any difference would be the attention's."""
    from repro_torch.models import attention as attn

    g = torch.Generator(device=cuda)
    g.manual_seed(8)

    def grid(*shape):
        return (torch.randint(-2, 3, shape, generator=g, device=cuda) / 4).bfloat16()

    spec = attn.AttnSpec(n_heads=32, n_kv_heads=8, head_dim=64)
    d, plen, c = 256, 40, 16
    tp = {"wq": grid(d, 2048), "wk": grid(d, 512), "wv": grid(d, 512),
          "wo": grid(2048, d)}
    x = grid(1, 48, d)
    q, k, v = attn._project_qkv(tp, x, spec, torch.arange(48, device=cuda)[None])
    bare = attn.chunked_attention(q[:, :plen], k[:, :plen], v[:, :plen], spec)
    assert torch.equal(attn.chunked_attention(q, k, v, spec)[:, :plen], bare)
    pool = attn.init_paged_pool(7, 16, spec, torch.bfloat16, torch.device(cuda))
    table = torch.tensor([[3, 5, 1, 6, 2]], device=cuda)
    for start in range(0, plen, c):
        out, pool = attn.paged_prefill_attention(tp, x[:, start:start + c], pool,
                                                 table, start, plen, spec)
        n = min(c, plen - start)
        assert torch.equal(out[:, :n], bare[:, start:start + n].reshape(1, n, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 16])
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
def test_engine_matches_static_generate_on_card(cuda, fmt, chunk):
    """The reduced llama in bf16 on the card: a ragged trace through the
    engine gives static serving's tokens bit for bit, through the cell's
    kernel."""
    from repro_torch import configs
    from repro_torch.core.sod import SoDConfig, sodify_params
    from repro_torch.models.model import LM
    from repro_torch.serving import Engine, poisson_trace, static_generate

    cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(
        sod=SoDConfig(mode=fmt, density=0.3, min_dim=64,
                      prune_method="block" if fmt == "block_csr" else "magnitude"))
    model = LM(cfg)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = sodify_params(model.init(gen, cuda), cfg.sod)
    trace = poisson_trace(6, 0.5, max_prompt=48, max_new=10, vocab=cfg.vocab, seed=0)
    counter = sm if fmt == "tiled_csc" else bmm
    with torch.inference_mode():
        counter.launches = 0
        res = Engine(model, params, max_slots=4, page_size=16, max_len=64,
                     prefill_chunk=chunk).run(trace)
        assert counter.launches > 0
        assert res["stats"]["completed"] == len(trace)
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req)


# ---------------------------------------------------------------------------
# the engine's other stages: verify rows, page swapping, spec decoding,
# preemption, prefix sharing and the prefix cache, on the card
# ---------------------------------------------------------------------------
def _packed_attention(dev, fmt, seed):
    """Full width's attention projections (d_model 2048, 32 / 8 heads of 64),
    bf16, pruned to 0.3 and packed in ``fmt``."""
    from repro_torch.core.sod import SoDConfig, pack_param

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    cfg = SoDConfig(mode=fmt, density=0.3, min_dim=64,
                    prune_method="block" if fmt == "block_csr" else "magnitude")
    shapes = {"wq": (2048, 2048), "wk": (2048, 512), "wv": (2048, 512),
              "wo": (2048, 2048)}
    return {name: pack_param((torch.randn(*kn, generator=g, device=dev)
                              * 2048 ** -0.5).bfloat16(), cfg)
            for name, kn in shapes.items()}, g


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
@pytest.mark.parametrize("k", [2, 4])
def test_verify_rows_equal_sequential_decode_on_card(cuda, k, fmt):
    """Full width's attention layer in bf16, 4 slots, packed weights: row i of
    a (k + 1)-position verify pass equals the i-th of k + 1 sequential paged
    decode steps bit for bit, and both leave the pool with the same bits;
    the verify block's norms (a window position at a time) give the decode
    step's rows."""
    from repro_torch.models import attention as attn
    from repro_torch.models import layers, transformer

    tp, g = _packed_attention(cuda, fmt, seed=10 + k)
    spec = attn.AttnSpec(n_heads=32, n_kv_heads=8, head_dim=64)
    c, slots, n_logical = k + 1, 4, 6
    pool = {name: torch.randn(1 + slots * n_logical, 16, 8, 64, generator=g,
                              device=cuda).bfloat16() for name in ("k", "v")}
    tables = (torch.randperm(slots * n_logical, generator=g, device=cuda)
              .reshape(slots, n_logical) + 1)
    start = torch.tensor([33, 47, 60, 75 - k], device=cuda)
    x = torch.randn(slots, c, 2048, generator=g, device=cuda).bfloat16()
    seq_pool = {name: t.clone() for name, t in pool.items()}
    rows = []
    for i in range(c):
        out, seq_pool = attn.paged_decode_attention(tp, x[:, i:i + 1], seq_pool, tables,
                                                    start + i, spec)
        rows.append(out[:, 0])
    out, ver_pool = attn.paged_verify_attention(
        tp, x, {name: t.clone() for name, t in pool.items()}, tables, start,
        torch.full((slots,), 80, device=cuda), spec)
    torch.cuda.synchronize()
    for i in range(c):
        assert torch.equal(out[:, i], rows[i]), i
    for name in ("k", "v"):
        assert torch.equal(ver_pool[name], seq_pool[name])
    gain = torch.randn(2048, generator=g, device=cuda) * 0.1
    window = transformer._norm_rows(x, gain, 1e-6)
    for i in range(c):
        assert torch.equal(window[:, i],
                           layers.rms_norm(x[:, i:i + 1].contiguous(), gain)[:, 0])


def _reduced_on_card(dev, fmt, dtype="bfloat16"):
    """The reduced llama on the card, its raw weights (seed 0) and their
    packing in ``fmt`` at 0.3 (block-pruned for block_csr)."""
    from repro_torch import configs
    from repro_torch.core.sod import SoDConfig, sodify_params
    from repro_torch.models.model import LM

    sod = SoDConfig(mode=fmt, density=0.3, min_dim=64,
                    prune_method="block" if fmt == "block_csr" else "magnitude")
    cfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(dtype=dtype, sod=sod)
    model = LM(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    raw = model.init(gen, dev)
    return model, raw, sodify_params(raw, sod)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
def test_verify_chunk_rows_equal_sequential_decode_on_card(cuda, fmt, monkeypatch):
    """The reduced llama in bf16 with packed weights: every row of a verify
    window's final-normed hidden state (the LM head left out: it is one
    cuBLAS GEMM, not held) equals the sequential paged decode step's, and
    the pools agree."""
    from repro_torch.models import transformer

    monkeypatch.setattr(transformer, "_head", lambda params, h, cfg: h)
    model, _, params = _reduced_on_card(cuda, fmt)
    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    pool = model.init_paged_pool(25, 16, cuda)
    for name in ("k", "v"):
        pool[name].normal_(generator=g)
    tables = torch.randperm(24, generator=g, device=cuda).reshape(4, 6) + 1
    tokens = torch.randint(0, model.cfg.vocab, (4, 3), generator=g, device=cuda)
    start, valid = torch.tensor([33, 47, 60, 70], device=cuda), torch.full((4,), 80,
                                                                          device=cuda)
    seq_pool = {name: t.clone() for name, t in pool.items()}
    with torch.inference_mode():
        rows = []
        for i in range(3):
            hidden, seq_pool = model.paged_decode_step(params, seq_pool, tables,
                                                       tokens[:, i:i + 1], start + i,
                                                       valid)
            rows.append(hidden[:, 0])
        hidden, ver_pool = model.verify_chunk(
            params, {name: t.clone() for name, t in pool.items()}, tables, tokens,
            start, valid)
    for i in range(3):
        assert torch.equal(hidden[:, i], rows[i]), i
    for name in ("k", "v"):
        assert torch.equal(ver_pool[name], seq_pool[name])


@pytest.mark.cuda
def test_swap_round_trip_bit_exact_on_card(cuda):
    """A preempted sequence's pages go to host memory and come back at fresh
    page ids bit for bit (compared as raw int16), though the freed pages
    were overwritten meanwhile; its tokens stay static serving's."""
    import numpy as np

    from repro_torch.serving import Engine, Request, static_generate

    model, _, params = _reduced_on_card(cuda, "tiled_csc")
    req = Request(rid=0, tokens=np.arange(1, 41, dtype=np.int32), max_new=12)
    with torch.inference_mode():
        eng = Engine(model, params, max_slots=2, page_size=16, max_len=64,
                     prefill_chunk=16, preemption=True)
        eng.submit(req)
        for _ in range(5):                      # 3 prefill chunks, 2 decode steps
            eng.step()
        (seq,) = eng.sched.active.values()
        old = list(seq.pages)
        before = {n: eng.pool[n][:, old].clone().view(torch.int16) for n in ("k", "v")}
        eng._preempt(seq)
        assert seq.host_kv[0]["k"].device.type == "cpu"
        for name in ("k", "v"):
            eng.pool[name][:, old] = -1
        eng._swap_in(seq)
        torch.cuda.synchronize()
        for name in ("k", "v"):
            assert torch.equal(eng.pool[name][:, seq.pages].view(torch.int16), before[name])
        res = eng.run()
        assert res["tokens"][0] == static_generate(model, params, req)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
@pytest.mark.parametrize("run", ["spec", "stress_spec", "cache"])
def test_engine_stages_match_static_generate_on_card(cuda, fmt, run, tmp_path):
    """The reduced llama in bf16 on the card: speculative decoding with a
    draft of the same raw weights at 0.12, every feature composed on a
    starved pool, and two epochs through the prefix cache each give static
    serving's tokens bit for bit, through the cell's kernel, and leave the
    pool clean."""
    from repro_torch.core.sod import sodify_params
    from repro_torch.runtime.planner import _draft_sod_cfg
    from repro_torch.serving import (Engine, poisson_trace, repeated_prompt_trace,
                                     static_generate, stress_spec_trace)

    model, raw, params = _reduced_on_card(cuda, fmt)
    vocab = model.cfg.vocab
    counter = sm if fmt == "tiled_csc" else bmm
    kw = dict(max_slots=4, page_size=16, max_len=64)
    if run == "spec":
        trace = poisson_trace(6, 0.5, max_prompt=40, max_new=12, vocab=vocab, seed=0)
        kw.update(spec_k=2, draft_params=sodify_params(raw, _draft_sod_cfg(model.cfg.sod,
                                                                           0.12)))
    elif run == "stress_spec":
        trace = stress_spec_trace(8, prefix_len=16, max_prompt=40, max_new=12,
                                  vocab=vocab, seed=0, burst=2, rate=0.3)
        kw.update(spec_k=2, prefill_chunk=16, preemption=True, prefix_sharing=True,
                  n_pages=6, draft_params=sodify_params(raw, _draft_sod_cfg(
                      model.cfg.sod, 0.12)))
    else:
        trace = [r for base in (0, 3) for r in repeated_prompt_trace(
            3, prefix_len=16, suffix_len=16, max_new=6, vocab=vocab, page_size=16,
            rid_base=base)]
        kw.update(prefill_chunk=16, prefix_sharing=True, prefix_cache_budget=1,
                  prefix_cache_dir=str(tmp_path))
    with torch.inference_mode():
        counter.launches = 0
        eng = Engine(model, params, **kw)
        res = eng.run(trace)
        assert counter.launches > 0
        for req in trace:
            assert res["tokens"][req.rid] == static_generate(model, params, req), req.rid
        eng.flush_prefix_cache()
    s = res["stats"]
    assert s["completed"] == len(trace) and s["logits_finite"]
    if run != "cache":
        assert s["spec_windows"] > 0
    if run == "stress_spec":
        assert s["preemptions"] >= 1
    if run == "cache":
        assert s["prefix_restored_pages"] >= 1
    assert eng.page_pool.free_count == eng.page_pool.n_pages - 1
    assert eng.trie is None or len(eng.trie) == 0


# ---------------------------------------------------------------------------
# tuned dispatch across each CUDA impl's parameter grid
# ---------------------------------------------------------------------------
TUNED_M = (4, 8, 16, 40, 64, 128)


def _tuned_cache(tmp_path, impl, p, params):
    """A tuning cache whose entries give ``impl`` the launch ``params`` at
    every M bucket of TUNED_M (and at M = 1), installed for dispatch."""
    from repro_torch.kernels import autotune, registry

    cache = autotune.TuningCache(tmp_path / "tuned.json")
    for m in (1, *TUNED_M):
        cache.put(registry.problem_key(p, m=m, backend="cuda"), impl.name, params,
                  us=1.0)
    autotune.set_cache(cache)
    return cache


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sod_matmul", "block_matmul"])
@pytest.mark.parametrize("k,n", [(2048, 512), (8192, 2048)])
def test_tuned_grid_rows_invariant_and_within_tol(cuda, k, n, kernel, tmp_path):
    """For every point of the CUDA impl's parameter grid, through tuned
    dispatch (``ops.sod_matmul`` reading a tuning cache): a row computed
    alone equals the same row in a call of each M of TUNED_M, bit for bit,
    and every call stays within TOL of the plain version (bf16)."""
    from repro_torch.kernels import autotune, ops, registry

    make = _case if kernel == "sod_matmul" else _block_case
    x, p = make(cuda, k, n, max(TUNED_M), torch.bfloat16)
    impl = registry.get_impl("cuda_fused" if kernel == "sod_matmul" else "cuda_block")
    counter = sm if kernel == "sod_matmul" else bmm
    key = registry.problem_key(p, m=max(TUNED_M), backend="cuda")
    grid = {tuple(sorted(g.items())) for g in impl.param_grid(key)}
    ref_y = ref.sod_matmul_ref(x, p).float()
    tol = TOL[torch.bfloat16] * ref_y.abs().max().item()
    try:
        for point in sorted(grid):
            _tuned_cache(tmp_path, impl, p, dict(point))
            with registry.record_dispatches() as log:
                before = counter.launches
                outs = {m: ops.sod_matmul(x[:m], p) for m in TUNED_M}
                alone = {row: ops.sod_matmul(x[row:row + 1], p) for row in (0, 3, 37, 127)}
                torch.cuda.synchronize()
            assert counter.launches == before + len(outs) + len(alone)
            assert {(r["impl"], r["source"]) for r in log} == {(impl.name, "tuned")}
            assert all(r["params"] == dict(point) for r in log)
            for m, y in outs.items():
                assert (y.float() - ref_y[:m]).abs().max().item() <= tol, (point, m)
                for row, a in alone.items():
                    if row < m:
                        assert torch.equal(y[row], a[0]), (point, row, m)
    finally:
        autotune.set_cache(None)


@pytest.mark.cuda
def test_tuned_params_leave_the_splits(cuda):
    """On this card's SM count, no point of either CUDA impl's grid changes
    the K splits at any M of TUNED_M: the tunables are all M-local."""
    from repro_torch.kernels import registry

    for make, plan_of, name in ((_case, sm.plan_of, "cuda_fused"),
                                (_block_case, bmm.plan_of, "cuda_block")):
        x, p = make(cuda, 8192, 2048, 128, torch.bfloat16)
        key = registry.problem_key(p, m=128, backend="cuda")
        grid = registry.get_impl(name).param_grid(key)
        splits = {plan_of(x[:m], p, **point).splits for m in TUNED_M for point in grid}
        assert splits == {plan_of(x[:1], p).splits}, name


@pytest.mark.cuda
def test_autotune_on_card_measures_only_the_kernel(cuda, tmp_path):
    """The tuner on the card's clock: only the CUDA impl is measured (the
    plain version is never a candidate), every time is positive, and the
    winner's launch serves the next dispatch."""
    from repro_torch.kernels import autotune, ops, registry

    x, p = _case(cuda, 2048, 512, 4, torch.bfloat16)
    cache = autotune.TuningCache(tmp_path / "tc.json")
    trials = []
    entry = autotune.tune(x, p, cache=cache, iters=3, trials_out=trials)
    assert {name for name, _, _ in trials} == {"cuda_fused"}
    assert all(us > 0 for _, _, us in trials)
    autotune.set_cache(cache)
    try:
        with registry.record_dispatches() as log:
            ops.sod_matmul(x, p)
        assert log[-1]["source"] == "tuned" and log[-1]["params"] == entry["params"]
        with pytest.raises(RuntimeError, match="CPU only"):
            ops.sod_matmul(x, p, impl="jnp")
    finally:
        autotune.set_cache(None)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
def test_engine_under_a_tuned_plan_matches_static_generate_on_card(cuda, fmt,
                                                                   tmp_path):
    """The reduced llama in bf16: a plan built from the weights, the cache
    tuned at static serving's M, the engine (other M buckets) under that
    plan and cache gives static_generate's tokens bit for bit, through the
    cell's kernel only."""
    from repro_torch.kernels import autotune, registry
    from repro_torch.runtime import planner
    from repro_torch.serving import Engine, poisson_trace, static_generate
    from repro_torch.core.sod import sodify_params

    model, raw, _ = _reduced_on_card(cuda, fmt)
    cache = autotune.install_cache(tmp_path / "tc.json")
    try:
        plan = planner.build_plan(raw, model.cfg.sod, cfg=model.cfg, m_values=(128, 4))
        params = sodify_params(raw, model.cfg.sod, plan=plan)
        stats = planner.warmup_plan(plan, (128, 4), cache=cache, iters=3)
        assert stats["tuned"] > 0
        trace = poisson_trace(6, 0.5, max_prompt=40, max_new=10, vocab=model.cfg.vocab,
                              seed=0)
        with torch.inference_mode(), registry.record_dispatches() as log:
            res = Engine(model, params, max_slots=4, page_size=16, max_len=64,
                         plan=plan).run(trace)
            for req in trace:
                assert res["tokens"][req.rid] == static_generate(model, params, req,
                                                                 plan=plan), req.rid
        assert not any(r["impl"] == "torch_oracle" for r in log)
    finally:
        autotune.set_cache(None)


# ---------------------------------------------------------------------------
# training: the kernels under their autograd.Functions
# ---------------------------------------------------------------------------
def _grads(x, p, impl):
    """d sum(y²) / d (x, the operand's float buffers) with y = x @ W through
    ``ops.sod_matmul`` forced to ``impl`` (``cuda``: the kernel's Function;
    ``jnp`` on a CPU copy: autograd over the plain version)."""
    from repro_torch.kernels import ops

    x = x.detach().clone().requires_grad_(True)
    names = [f for f in ("vals", "block_vals", "scale", "codebook")
             if getattr(p, f, None) is not None and getattr(p, f).is_floating_point()]
    leaves = {f: getattr(p, f).detach().clone().requires_grad_(True) for f in names}
    y = ops.sod_matmul(x, dataclasses.replace(p, **leaves), impl=impl)
    (y.float() ** 2).sum().backward()
    return {"x": x.grad, **{f: t.grad for f, t in leaves.items()}}


def _to_cpu(p):
    return dataclasses.replace(p, **{f.name: getattr(p, f.name).cpu()
                                     for f in dataclasses.fields(p)
                                     if isinstance(getattr(p, f.name), torch.Tensor)})


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ALL_QMODES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel,k,n,m", [
    ("sod_matmul", 2048, 512, 64), ("sod_matmul", 300, 260, 77),
    ("block_matmul", 2048, 512, 64), ("block_matmul", 300, 260, 77)])
def test_function_grads_match_plain_autograd_on_card(cuda, kernel, k, n, m, dtype, qmode):
    """The Function (kernel forward, analytical backward through the
    decompress kernel) against autograd over ``kernels/ref.py`` on the same
    operand on the CPU; padding slots get exactly 0."""
    if kernel == "sod_matmul":
        x, p = _case(cuda, k, n, m, dtype)
        before = (sm.launches, dk.launches)
    else:
        x, p = _block_case(cuda, k, n, m, dtype)
        before = (bmm.launches, dk.launches)
    p = _operand(p, qmode)
    got = _grads(x, p, "cuda")
    torch.cuda.synchronize()
    after = (sm.launches if kernel == "sod_matmul" else bmm.launches, dk.launches)
    assert after[0] == before[0] + 1
    assert after[1] == before[1] + (kernel == "sod_matmul")
    want = _grads(x.cpu(), _to_cpu(p), "jnp")
    assert set(got) == set(want)
    for name, g in want.items():
        tol = TOL[torch.bfloat16 if g.dtype == torch.bfloat16 else torch.float32]
        if g.dtype == torch.float8_e4m3fn:
            tol = 2**-3      # one e4m3 rounding of the gradient
        a, b = got[name].float().cpu(), g.float()
        assert got[name].dtype == g.dtype, name
        assert (a - b).abs().max().item() <= tol * b.abs().max().item(), name
    field = "vals" if kernel == "sod_matmul" else "block_vals"
    if field in got:
        pad = (p.rows < 0) if kernel == "sod_matmul" else \
            (p.block_ids < 0)[..., None, None].expand(p.block_vals.shape)
        assert (got[field][pad] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("wdtype", [torch.bfloat16, torch.float32])
def test_dense_matmul_backward_on_card(cuda, wdtype):
    """``ops.dense_matmul`` with f32 out (the tied LM head's call) has a
    derivative on the card, where it runs ``aten::mm.dtype``, and its
    gradients are the CPU path's within one bf16 rounding."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(64, 2048, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(2048, 4096, generator=g, device=cuda) * 0.02).to(wdtype)
    t = torch.randn(64, 4096, generator=g, device=cuda)
    out = {}
    for dev in ("cuda", "cpu"):
        xs, ws = (a.detach().to(dev).requires_grad_(True) for a in (x, w))
        y = ops.dense_matmul(xs, ws, torch.float32)
        assert y.dtype == torch.float32
        (y * t.to(dev)).sum().backward()
        out[dev] = (y.detach().cpu(), xs.grad.cpu(), ws.grad.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.dtype == b.dtype
        assert (a.float() - b.float()).abs().max() <= 2**-7 * b.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["tiled_csc", "block_csr"])
def test_train_step_on_card_matches_cpu(cuda, fmt):
    """One ``make_train_step`` of the reduced model in float32 on the card
    (every packed matmul through its kernel's Function) against the same
    step on the CPU (autograd over the plain version): loss and gradients
    within 1e-4 of their largest magnitude, parameters after the step within
    a tenth of a step (lr 1e-3), integer leaves and padding unchanged."""
    from repro_torch.core.tree import leaves_with_path, tree_map
    from repro_torch.kernels import registry
    from repro_torch.launch import steps
    from repro_torch.optim import AdamW, AdamWConfig

    model, _, params = _reduced_on_card(cuda, fmt, dtype="float32")
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, model.cfg.vocab, (4, 65), generator=gen)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    out = {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        with registry.count_dispatches() as counts:
            loss, _, grads = steps.make_loss_and_grads(model)(p, b)
        opt = AdamW(AdamWConfig(lr=1e-3))
        new, _, _ = steps.make_train_step(model, opt)(p, opt.init(p), b)
        out[dev] = (loss.cpu(), tree_map(lambda t: t.cpu(), grads),
                    tree_map(lambda t: t.cpu(), new), dict(counts))
    impl = "cuda_fused" if fmt == "tiled_csc" else "cuda_block"
    assert set(out["cuda"][3]) == {f"{impl}[prior]"}
    assert set(out["cpu"][3]) == {"torch_oracle[prior]"}
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * abs(out["cpu"][0])
    for (name, a), (_, b) in zip(leaves_with_path(out["cuda"][1]),
                                 leaves_with_path(out["cpu"][1])):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-8, name
    for (name, a), (_, b) in zip(leaves_with_path(out["cuda"][2]),
                                 leaves_with_path(out["cpu"][2])):
        if a.is_floating_point():
            assert (a - b).abs().max() <= 1e-4, name
        else:
            assert torch.equal(a, b), name


@pytest.mark.cuda
def test_serving_under_inference_mode_builds_no_graph(cuda, monkeypatch):
    """Serving runs under ``torch.inference_mode``: no kernel goes through
    its autograd.Function and no output carries a graph."""
    from repro_torch.kernels import vjp
    from repro_torch.launch import serve

    def refuse(*a, **kw):
        raise AssertionError("a serving matmul went through its autograd.Function")

    monkeypatch.setattr(vjp, "fused_matmul", refuse)
    monkeypatch.setattr(vjp, "block_matmul", refuse)
    for fmt in ("tiled_csc", "block_csr"):
        before = sm.launches + bmm.launches
        summary = serve.main(["--reduced", "--sod", fmt, "--density", "0.3",
                              "--batch", "2", "--prompt-len", "16", "--gen", "4"])
        assert sm.launches + bmm.launches == before + 2 * 7 * 5
        assert summary["logits_finite"]
    model, _, params = _reduced_on_card(cuda, "tiled_csc")
    with torch.inference_mode():
        logits, _ = model.apply(params, torch.zeros((1, 8), dtype=torch.long, device=cuda))
    assert logits.grad_fn is None and not logits.requires_grad


# ---------------------------------------------------------------------------
# decompress: persistent CTAs, a bulk-copy ring of tile slabs, 16-byte rows
# ---------------------------------------------------------------------------
def _check_decompress(p, out_dtype=None):
    """One launch, bit-equal to the plain version in dtype, shape and bits."""
    before = dk.launches
    d = dk.decompress(p, out_dtype)
    torch.cuda.synchronize()
    assert dk.launches == before + 1
    want = ref.decompress_tiled_ref(p, out_dtype)
    assert d.shape == tuple(p.shape) and d.dtype == want.dtype
    assert torch.equal(d, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n,more_tiles", [(8192, 2048, True), (2048, 512, False)])
def test_decompress_persistent_grid(cuda, k, n, more_tiles, dtype):
    """More tiles than CTAs (each CTA walks several through its ring) and
    fewer tiles than SMs (one tile a CTA)."""
    _, p = _case(cuda, k, n, 1, dtype)
    plan = dk.plan_of(p, dtype)
    tiles = p.grid[0] * p.grid[1]
    if more_tiles:
        assert plan.grid < tiles
    else:
        assert plan.grid == tiles < sm.sm_count(cuda.index or 0)
    _check_decompress(p)


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,n", [(300, 260), (200, 130), (129, 33)])
def test_decompress_unaligned_row_starts(cuda, k, n, out_dtype):
    """In bf16 these rows do not start 16-byte aligned (n * 2 % 16 != 0):
    the kernel writes them element by element, and the ragged edge too."""
    _, p = _case(cuda, k, n, 1, torch.bfloat16, 0.4)
    _check_decompress(p, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decompress_cap_one_and_padding_tiles(cuda, dtype):
    """One slot a column (cap = 1: a slab of bn values), and tiles whose
    every slot is padding, beside a weight of zeros."""
    k, n = 1000, 700
    col = torch.arange(n, device=cuda)
    w = torch.zeros(k, n, device=cuda)
    w[col % k, col] = torch.randn(n, generator=torch.Generator(device=cuda).manual_seed(4),
                                  device=cuda)
    p = pack_tiled_csc(w.to(dtype))
    assert ((p.rows >= 0).sum(dim=2) <= 1).all()
    # the one real slot of each column (padding holds row -1 and value 0)
    one = dataclasses.replace(p, vals=p.vals.sum(dim=2, keepdim=True).to(dtype),
                              rows=p.rows.max(dim=2, keepdim=True).values)
    assert one.cap == 1 and (one.rows < 0).all(dim=(2, 3)).any()
    _check_decompress(one)
    _check_decompress(one, torch.float32)
    _check_decompress(pack_tiled_csc(torch.zeros(k, n, dtype=dtype, device=cuda)))


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", QMODES)
def test_quantized_decompress_full_width_both_dtypes(cuda, qmode):
    """Every quantized qmode at 8192 x 2048, to f32 (the default) and bf16."""
    _, p = _case(cuda, 8192, 2048, 1, torch.bfloat16)
    q = quantize_packed(p, qmode)
    _check_decompress(q)
    _check_decompress(q, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("qmode", ALL_QMODES)
def test_decompress_stacked_layer_view(cuda, qmode):
    """packed.layer(i) is a view into the stacked buffers; a view at an
    offset a bulk copy cannot take raises."""
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    w = magnitude_prune(torch.randn(3, 2048, 512, generator=g, device=cuda), 0.3)
    stacked = _operand(pack_tiled_csc(w.bfloat16()), qmode)
    for i in range(3):
        layer = stacked.layer(i)
        assert layer.vals.data_ptr() == stacked.vals.data_ptr() + i * layer.vals.nbytes
        _check_decompress(layer)
    layer = stacked.layer(1)
    flat = torch.empty(layer.rows.numel() + 1, dtype=layer.rows.dtype, device=cuda)
    off = flat[1:].view(layer.rows.shape)
    off.copy_(layer.rows)
    with pytest.raises(ValueError, match="aligned"):
        dk.decompress(dataclasses.replace(layer, rows=off))


@pytest.mark.cuda
@pytest.mark.parametrize("launch", [{"CTAS_PER_SM": 1}, {"CTAS_PER_SM": 3},
                                    {"CTAS_PER_SM": 1, "THREADS": 1024},
                                    {"THREADS": 256}, {"THREADS": 128},
                                    {"THREADS": 1024}])
@pytest.mark.parametrize("qmode", ALL_QMODES)
def test_decompress_every_plan_bit_equal(cuda, launch, qmode, monkeypatch):
    """The output does not depend on the launch plan: each tile is written
    by exactly one CTA, whatever the grid, the threads, the ring or the
    dense tiles (one or two, by the output dtype and the CTAs an SM)."""
    for name, value in launch.items():
        monkeypatch.setattr(dk, name, value)
    dk.plan_launch.cache_clear()
    try:
        _, p = _case(cuda, 2048, 4096, 1, torch.bfloat16, seed=6)
        q = _operand(p, qmode)
        for dtype in (None, torch.bfloat16, torch.float32):
            out = dtype or (torch.float32 if qmode != "none" else torch.bfloat16)
            plan = dk.plan_of(q, out)
            assert plan.grid < q.grid[0] * q.grid[1]
            assert plan.ctas_per_sm <= dk.CTAS_PER_SM
            _check_decompress(q, dtype)
    finally:
        dk.plan_launch.cache_clear()


# ---------------------------------------------------------------------------
# the MoE block on the card
# ---------------------------------------------------------------------------
def _moe_on(tree, dev, dtype):
    """MoE weights on ``dev``: the router and shared gate in float32, as
    ``init_moe`` makes them, the rest in ``dtype``."""
    return {k: _moe_on(v, dev, dtype) if isinstance(v, dict) else
            v.to(dev, torch.float32 if k in ("router", "shared_gate") else dtype)
            for k, v in tree.items()}


def _moe_case(dev, spec, dtype, seed=0, t=64):
    """(CPU float32 weights, CPU x (2, t/2, d), the same on ``dev`` in
    ``dtype``) of an MoE block drawn from ``seed``."""
    from repro_torch.models import moe

    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    params = moe.init_moe(g, spec, torch.float32, torch.device("cpu"))
    params["router"] = params["router"] * 8      # sharper routing than N(0, 1/d)
    x = torch.randn(2, t // 2, spec.d_model, generator=g)
    return params, x, _moe_on(params, dev, dtype), x.to(dev, dtype)


MOE_SPECS = {"granite": dict(n_experts=32, n_experts_padded=32, top_k=8, d_model=1024,
                             d_ff=512),
             "qwen": dict(n_experts=60, n_experts_padded=64, top_k=4, d_model=2048,
                          d_ff=1408, n_shared=4, d_shared_ff=5632)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_SPECS)
def test_moe_mlp_on_card_matches_cpu_f32(cuda, arch):
    """The MoE block at the configs' widths in float32: the card's output and
    aux loss against the CPU run of the same weights (sums in another
    order, TF32 off), the same experts chosen."""
    from repro_torch.models import moe

    spec = moe.MoESpec(**MOE_SPECS[arch])
    params, x, dparams, dx = _moe_case(cuda, spec, torch.float32)
    want, want_aux = moe.moe_mlp(params, x, spec)
    got, aux = moe.moe_mlp(dparams, dx, spec)
    tol = TOL[torch.float32] * want.abs().max().item()
    assert (got.cpu() - want).abs().max().item() <= tol
    assert abs(aux.item() - want_aux.item()) <= 1e-5 * want_aux.item()
    ids = lambda p, xx: moe._top_k(torch.softmax(moe.router_logits(  # noqa: E731
        p, xx.reshape(-1, spec.d_model), spec), -1), spec.top_k)[1]
    assert torch.equal(ids(dparams, dx).cpu(), ids(params, x))


@pytest.mark.cuda
@pytest.mark.parametrize("reduced_precision", [False, True])
def test_moe_expert_products_keep_f32_sums(cuda, reduced_precision, monkeypatch):
    """``ops.dense_matmul`` on bf16 expert stacks sums in float32 whatever
    ``allow_bf16_reduced_precision_reduction`` says: its f32 result is the
    widened operands' f32 product (sums in another order), far inside
    what a bf16 reduction would drift, and so are both gradients."""
    from repro_torch.kernels import ops

    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", reduced_precision)
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    a = torch.randn(64, 128, 2048, generator=g, device=cuda).bfloat16()
    b = (torch.randn(64, 2048, 1408, generator=g, device=cuda) / 45).bfloat16()
    want = torch.bmm(a.float(), b.float())
    got = ops.mm_f32(a, b)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert torch.equal(ops.dense_matmul(a, b, torch.bfloat16), got.bfloat16())
    a.requires_grad_(True)
    b.requires_grad_(True)
    cot = torch.randn(64, 128, 1408, generator=g, device=cuda)
    ops.dense_matmul(a, b, torch.float32).backward(cot)
    ga = torch.bmm(cot, b.detach().float().transpose(1, 2))
    gb = torch.bmm(a.detach().float().transpose(1, 2), cot)
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    assert (a.grad.float() - ga).abs().max().item() <= 2**-7 * ga.abs().max().item()
    assert (b.grad.float() - gb).abs().max().item() <= 2**-7 * gb.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_SPECS)
def test_router_and_shared_gate_rows_invariant(cuda, arch):
    """The router logits and the shared gate in bf16: a row's bits are the
    same alone (static decode), among the engine's 4 slots, at a 64-token
    prompt bucket and at 128 rows (static prefill), so the experts chosen
    for a token do not depend on the rows beside it."""
    from repro_torch.models import moe

    spec = moe.MoESpec(**MOE_SPECS[arch])
    _, _, params, x = _moe_case(cuda, spec, torch.bfloat16, t=128)
    xt = x.reshape(-1, spec.d_model)
    fns = {"router": lambda m: moe.router_logits(params, xt[:m], spec)}
    if spec.n_shared:
        fns["shared_gate"] = lambda m: moe.shared_gate(params, xt[:m])
    for name, fn in fns.items():
        outs = {m: fn(m) for m in (1, 4, 64, 128)}
        for row in (0, 3, 37, 127):
            for m, y in outs.items():
                if row < m:
                    alone = (outs[1] if row == 0 else
                             (moe.router_logits(params, xt[row:row + 1], spec)
                              if name == "router" else
                              moe.shared_gate(params, xt[row:row + 1])))
                    assert torch.equal(y[row], alone[0]), (name, row, m)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,density", [((2048, 1408), 0.3), ((300, 260), 0.05),
                                           ((64, 1024, 512), 0.3), ((128, 128), 1e-6)])
def test_magnitude_prune_on_card_equals_cpu(cuda, shape, density, dtype):
    """The card's threshold (a sort) is the CPU's (``torch.kthvalue``): the
    same mask bit for bit, ties at the threshold (frequent in bf16) kept
    alike."""
    from repro_torch.core.pruning import magnitude_prune

    g = torch.Generator(device="cpu")
    g.manual_seed(11)
    w = torch.randn(*shape, generator=g).to(dtype)
    assert torch.equal(magnitude_prune(w.to(cuda), density).cpu(),
                       magnitude_prune(w, density))


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [(16, 16, 128), (16, 8, 64), (32, 8, 64)])
def test_decode_attention_rows_invariant_at_moe_heads(cuda, heads):
    """Decode attention in bf16 at qwen2-moe-a2.7b's heads (one query head
    a KV head), granite-moe's and llama's: a row at batch 4 over the
    engine's 80 gathered positions has the bits of that row alone over
    static serving's shorter cache."""
    from repro_torch.models import attention as attn

    h, kv, hd = heads
    spec = attn.AttnSpec(n_heads=h, n_kv_heads=kv, head_dim=hd)
    g = torch.Generator(device=cuda)
    g.manual_seed(12)
    for _ in range(8):
        q = torch.randn(4, 1, h, hd, generator=g, device=cuda).bfloat16()
        k = torch.randn(4, 80, kv, hd, generator=g, device=cuda).bfloat16()
        v = torch.randn(4, 80, kv, hd, generator=g, device=cuda).bfloat16()
        pos = torch.randint(32, 79, (4,), generator=g, device=cuda)
        batch = attn._attend_cached(q, k, v, pos, spec, None)
        for row in range(4):
            p = int(pos[row])
            for s in (p + 1, min(p + 9, 80)):
                one = attn._attend_cached(q[row:row + 1], k[row:row + 1, :s],
                                          v[row:row + 1, :s], p, spec, None)
                assert torch.equal(batch[row], one[0]), (row, s)


@pytest.mark.cuda
def test_prefill_attention_rows_invariant_at_mha_heads(cuda):
    """Prefill attention at qwen2-moe-a2.7b's heads: a prompt's rows keep
    their bits at its page bucket."""
    from repro_torch.models import attention as attn

    spec = attn.AttnSpec(n_heads=16, n_kv_heads=16, head_dim=128)
    g = torch.Generator(device=cuda)
    g.manual_seed(13)
    for plen in (33, 47, 52, 64):
        bucket = -(-plen // 16) * 16
        q, k, v = (torch.randn(1, bucket, 16, 128, generator=g, device=cuda).bfloat16()
                   for _ in range(3))
        bare = attn.chunked_attention(q[:, :plen], k[:, :plen], v[:, :plen], spec)
        padded = attn.chunked_attention(q, k, v, spec)[:, :plen]
        assert torch.equal(bare, padded), plen


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1024, 2048])
def test_rms_norm_rows_of_four_equal_rows_alone(cuda, d):
    """RMSNorm at the engine's decode shape (4, 1, d) against static
    decode's (1, 1, d), every row, residual-stream magnitudes: no row's
    bits differ (its mean of squares is summed in float64)."""
    from repro_torch.models import layers

    g = torch.Generator(device=cuda)
    g.manual_seed(14)
    gain = torch.randn(d, generator=g, device=cuda) * 0.1
    x = (torch.randn(512, 4, 1, d, generator=g, device=cuda) * 30).bfloat16()
    for i in range(512):
        four = layers.rms_norm(x[i], gain)
        for r in range(4):
            assert torch.equal(four[r], layers.rms_norm(x[i, r:r + 1], gain)[0]), (i, r)


# ---------------------------------------------------------------------------
# the recurrent families (zamba2-2.7b, xlstm-125m) at full width
# ---------------------------------------------------------------------------
# (K, N, output dtype): zamba2's Mamba2 w_z / w_x and out_proj, its head;
# xlstm's wq / wk / wv and w_up, its head
RECURRENT_SHAPES = [(2560, 5120, None), (5120, 2560, None), (2560, 32000, torch.float32),
                    (1536, 1536, None), (768, 3072, None), (768, 50304, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [4, 128])
@pytest.mark.parametrize("k,n,out_dtype", RECURRENT_SHAPES)
@pytest.mark.parametrize("kernel,qmode", [("sod_matmul", "none"), ("sod_matmul", "int8"),
                                          ("block_matmul", "none")])
def test_kernels_at_recurrent_shapes(cuda, kernel, qmode, k, n, out_dtype, m):
    """Each matmul kernel at the recurrent families' shapes, bf16
    activations, against its plain version; ``decompress`` bit for bit."""
    g = torch.Generator(device=cuda)
    g.manual_seed(k + n + m)
    w = torch.randn(k, n, generator=g, device=cuda).bfloat16()
    x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    if kernel == "block_matmul":
        p = pack_block_csr(block_prune(w, 0.3))
        y, yr = bmm.block_matmul(x, p, out_dtype), ref.sod_matmul_ref(x, p, out_dtype)
    else:
        p = pack_tiled_csc(magnitude_prune(w, 0.3))
        if qmode != "none":
            p = quantize_packed(p, qmode)
        y, yr = sm.sod_matmul(x, p, out_dtype), ref.sod_matmul_ref(x, p, out_dtype)
        if m == 4:
            assert torch.equal(dk.decompress(p), ref.decompress_tiled_ref(p))
    torch.cuda.synchronize()
    assert y.dtype == yr.dtype
    tol = TOL[torch.bfloat16] * yr.float().abs().max().item()
    assert (y.float() - yr.float()).abs().max().item() <= tol


def _recurrent_blocks(dev):
    """Seeded full-width Mamba2 (zamba2-2.7b), mLSTM and sLSTM (xlstm-125m)
    weights, bf16, the Sparse-on-Dense projections packed tiled_csc at 0.3."""
    from repro_torch.core.sod import SoDConfig, pack_param
    from repro_torch.models import ssm, xlstm

    sod = SoDConfig(mode="tiled_csc", density=0.3, min_dim=64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    mspec = ssm.MambaSpec(d_model=2560, d_state=64, headdim=64)
    xspec = xlstm.XLSTMSpec(d_model=768, n_heads=4)
    mp = ssm.init_mamba(gen, mspec, torch.bfloat16, dev)
    mp = {k: pack_param(w, sod) if k in ("w_z", "w_x", "out_proj") else w
          for k, w in mp.items()}
    xp = xlstm.init_mlstm(gen, xspec, torch.bfloat16, dev)
    xp = {k: pack_param(w, sod) if k in ("w_up", "wq", "wk", "wv", "w_down") else w
          for k, w in xp.items()}
    sp = xlstm.init_slstm(gen, xspec, torch.bfloat16, dev)
    return mspec, mp, xspec, xp, sp


def _rows(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.cuda
def test_slstm_recurrence_rows_of_four_equal_rows_alone(cuda):
    """Fault C8: sLSTM's recurrent product ``einsum("bhd,hde->bhe")`` at
    xlstm-125m's heads (4 of 192) in float32 changed every row's bits on
    the card between batch 4 and 1; summed in float64 and rounded once
    (``layers.einsum_f32``), each row of 4 has the bits of the row alone,
    and so has a whole sLSTM step's state."""
    from repro_torch.models import layers, xlstm

    _, _, xspec, _, sp = _recurrent_blocks(cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(22)
    with torch.inference_mode():
        for _ in range(16):
            h = torch.randn(4, 4, 192, generator=g, device=cuda)
            four = layers.einsum_f32("bhd,hde->bhe", h, sp["r_gates"])
            x = torch.randn(4, 1, 768, generator=g, device=cuda).bfloat16()
            st = tuple(torch.randn(4, 4, 192, generator=g, device=cuda) for _ in range(4))
            y4, s4 = xlstm.slstm_scan(sp, x, xspec, st)
            for r in range(4):
                assert torch.equal(four[r], layers.einsum_f32(
                    "bhd,hde->bhe", h[r:r + 1], sp["r_gates"])[0]), r
                y1, s1 = xlstm.slstm_scan(sp, x[r:r + 1], xspec,
                                          tuple(t[r:r + 1] for t in st))
                assert torch.equal(y4[r], y1[0]) and all(
                    torch.equal(a[r], b[0]) for a, b in zip(s4, s1)), r


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["mamba", "mlstm"])
def test_recurrent_decode_rows_of_four_equal_rows_alone(cuda, block):
    """A Mamba2 decode step (zamba2-2.7b) and an mLSTM decode step
    (xlstm-125m) on packed bf16 weights: each row at the engine's batch of 4
    — output and new state — has the bits of the row alone (static
    serving's batch 1)."""
    from repro_torch.models import ssm, xlstm

    mspec, mp, xspec, xp, _ = _recurrent_blocks(cuda)
    g = torch.Generator(device=cuda)
    g.manual_seed(23)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * scale).to(dtype)

    with torch.inference_mode():
        for _ in range(8):
            if block == "mamba":
                x = randn(4, 1, 2560, dtype=torch.bfloat16)
                st = {"ssm": randn(4, 80, 64, 64),
                      "conv": {"x": randn(4, 3, 5120, dtype=torch.bfloat16),
                               "b": randn(4, 3, 64, dtype=torch.bfloat16),
                               "c": randn(4, 3, 64, dtype=torch.bfloat16)}}

                def run(r):
                    sub = {"ssm": st["ssm"][r], "conv": {k: t[r] for k, t in
                                                         st["conv"].items()}}
                    y, new = ssm.mamba_decode_step(mp, x[r], sub, mspec)
                    return (y, new["ssm"], *new["conv"].values())
            else:
                x = randn(4, 1, 768, dtype=torch.bfloat16)
                st = {"c": randn(4, 4, 384, 384, scale=0.1), "n": randn(4, 4, 384),
                      "m": randn(4, 4), "conv": randn(4, 3, 1536, dtype=torch.bfloat16)}

                def run(r):
                    y, new = xlstm.mlstm_block(xp, x[r], xspec,
                                               cache={k: t[r] for k, t in st.items()},
                                               decode=True)
                    return (y, *new.values())
            four = run(slice(0, 4))
            for r in range(4):
                one = run(slice(r, r + 1))
                for a, b in zip(four, one, strict=True):
                    assert torch.equal(a[r], b[0]), r


# ---------------------------------------------------------------------------
# the VLM and audio frontends (pixtral-12b, musicgen-medium) at full width
# ---------------------------------------------------------------------------
# (K, N, output dtype): pixtral's w_gate / w_up and w_down, its head;
# musicgen's head over its 4 codebooks
FRONTEND_SHAPES = [(5120, 14336, None), (14336, 5120, None), (5120, 131072, torch.float32),
                   (1536, 8192, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,out_dtype", FRONTEND_SHAPES)
@pytest.mark.parametrize("kernel,qmode", [("sod_matmul", "none"), ("sod_matmul", "int8"),
                                          ("block_matmul", "none")])
def test_kernels_at_frontend_shapes(cuda, kernel, qmode, k, n, out_dtype):
    """Each matmul kernel at the frontend families' shapes, bf16
    activations, at M = 4 and 128, against its plain version;
    ``decompress`` bit for bit."""
    g = torch.Generator(device=cuda)
    g.manual_seed(k + n)
    w = torch.randn(k, n, generator=g, device=cuda).bfloat16()
    if kernel == "block_matmul":
        p, fn = pack_block_csr(block_prune(w, 0.3)), bmm.block_matmul
    else:
        p, fn = pack_tiled_csc(magnitude_prune(w, 0.3)), sm.sod_matmul
        if qmode != "none":
            p = quantize_packed(p, qmode)
        assert torch.equal(dk.decompress(p), ref.decompress_tiled_ref(p))
    del w
    for m in (4, 128):
        x = torch.randn(m, k, generator=g, device=cuda).bfloat16()
        y, yr = fn(x, p, out_dtype), ref.sod_matmul_ref(x, p, out_dtype)
        torch.cuda.synchronize()
        assert y.dtype == yr.dtype
        tol = TOL[torch.bfloat16] * yr.float().abs().max().item()
        assert (y.float() - yr.float()).abs().max().item() <= tol, m


def _full_width(arch: str, layers: int):
    """The full-width config at ``layers``, bf16, with its seeded weights
    packed tiled_csc at density 0.3 on the card."""
    from repro_torch import configs
    from repro_torch.core.sod import SoDConfig, sodify_params
    from repro_torch.models.model import LM

    sod = SoDConfig(mode="tiled_csc", density=0.3, min_dim=64)
    cfg = configs.get_config(arch).with_(n_layers=layers, sod=sod)
    model = LM(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(31)
    return model, sodify_params(model.init(gen, "cuda"), sod)


@pytest.mark.cuda
def test_audio_head_reshaped_logits_equal_the_flat_kernel_output(cuda):
    """musicgen's packed head at decode (M = 4): the (4, 1, 4, 2048) logits
    are the kernel's (4, 8192) float32 output read codebook-major, bit for
    bit."""
    from repro_torch.core.formats import TiledCSC
    from repro_torch.models import transformer

    model, params = _full_width("musicgen-medium", 1)
    head = params["head"]
    assert isinstance(head, TiledCSC) and head.shape == (1536, 4 * 2048)
    g = torch.Generator(device=cuda)
    g.manual_seed(32)
    h = torch.randn(4, 1, 1536, generator=g, device=cuda).bfloat16()
    with torch.inference_mode():
        logits = transformer._head(params, h, model.cfg)
        flat = sm.sod_matmul(h.reshape(4, 1536), head, torch.float32)
    assert logits.shape == (4, 1, 4, 2048) and logits.dtype == torch.float32
    assert torch.equal(logits, flat.reshape(4, 1, 4, 2048))


@pytest.mark.cuda
def test_pixtral_decode_at_the_true_end_matches_its_forward(cuda):
    """pixtral-12b at full width and 2 layers, 1024 patches + 512 text
    tokens: the decode step at position 1536 (n_patches + text, where the
    cache puts the next token) equals the full forward over the prompt and
    that token (one attention chunk over 1537 positions) within 5 % of the
    largest logit, as ``chip_smoke.py`` holds the densified path; the
    decode at the text's length (R5, the reference's serving) does not."""
    from repro_torch.models.model import LM

    model, params = _full_width("pixtral-12b", 2)
    cfg = model.cfg
    g = torch.Generator(device=cuda)
    g.manual_seed(33)
    tokens = torch.randint(0, cfg.vocab, (1, 512), generator=g, device=cuda)
    patches = torch.randn(1, cfg.n_patches, cfg.frontend_dim, generator=g, device=cuda)
    with torch.inference_mode():
        last, cache = model.prefill(params, tokens, patch_embeds=patches)
        s = cfg.n_patches + tokens.shape[1]
        cache = model.grow_cache(cache, s + 1)
        nxt = last.argmax(-1).reshape(1, 1)
        wrong, _ = model.decode_step(params, {k: v.clone() for k, v in cache.items()},
                                     nxt, tokens.shape[1])
        step, _ = model.decode_step(params, cache, nxt, s)
        full = LM(cfg.with_(attn_chunk=s + 1)).apply(
            params, torch.cat([tokens, nxt], 1), patch_embeds=patches)[0][:, -1]
    scale = full.abs().max().item()
    assert torch.isfinite(step).all()
    assert (step[:, 0] - full).abs().max().item() <= 0.05 * scale
    assert (wrong[:, 0] - full).abs().max().item() > 0.05 * scale


@pytest.fixture(scope="module")
def mesh_plans(tmp_path_factory):
    """The five partition plans on a (2, 2) mesh of four ranks on the one
    card (``tests/torch_mesh_cases.py:card_plans``), run once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import pathlib

    from repro_torch.launch import mesh as mesh_mod

    work = tmp_path_factory.mktemp("mesh")
    cases = pathlib.Path(__file__).resolve().parent / "torch_mesh_cases.py"
    return mesh_mod.run_ranks(4, f"{cases}:card_plans", work, args=(work,), timeout=300)


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["dp", "col", "row", "gather_model", "gather_data"])
def test_mesh_plans_on_four_ranks(mesh_plans, plan):
    """Each rank launches its format's kernel once on its local problem; the
    gathered y is the single-process kernel's and the plain version's
    within the bf16 tolerance, and the same on every rank."""
    rows = {k: v for k, v in mesh_plans[0].items() if k.endswith(f"-{plan}")}
    # 2 formats x 2 M x the shapes the plan divides: (2048, 2048) and one
    # ragged, (300, 512) or, for the row plan, (512, 300); all three for dp
    assert len(rows) == (12 if plan == "dp" else 8)
    for name, row in rows.items():
        assert row["launches"] == 1, name
        assert row["vs_kernel"] <= TOL[torch.bfloat16], name
        assert row["vs_plain"] <= TOL[torch.bfloat16], name
        assert all(r[name]["checksum"] == row["checksum"] for r in mesh_plans), name


@pytest.fixture(scope="module")
def mesh_phase15(tmp_path_factory):
    """The rest of the distributed runtime on a (2, 2) mesh of four ranks on
    the one card (``tests/torch_mesh_cases.py:card_phase15``), run once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import pathlib

    from repro_torch.launch import mesh as mesh_mod

    work = tmp_path_factory.mktemp("mesh15")
    cases = pathlib.Path(__file__).resolve().parent / "torch_mesh_cases.py"
    return mesh_mod.run_ranks(4, f"{cases}:card_phase15", work, args=(work,), timeout=300)


@pytest.mark.cuda
def test_mesh_moe_a2a_on_card(mesh_phase15):
    """The all-to-all ran on every rank, its y within the bf16 tolerance of
    the capacity dispatch in as many blocks, the same on every rank."""
    for r in mesh_phase15:
        m = r["moe"]
        assert m["all_to_all"] > 0
        assert m["rel_err"] <= TOL[torch.bfloat16] and m["aux_err"] <= 1e-6
        assert m["checksum"] == mesh_phase15[0]["moe"]["checksum"]


@pytest.mark.cuda
def test_mesh_engine_on_card(mesh_phase15):
    assert all(r["engine"]["equal"] for r in mesh_phase15)


@pytest.mark.cuda
def test_mesh_restore_and_unplace_on_card(mesh_phase15):
    for r in mesh_phase15:
        assert r["restore"]["restored"] and r["restore"]["unplaced"]


@pytest.mark.cuda
def test_mesh_elastic_on_card(mesh_phase15):
    """Ranks 2 and 3 lost; the survivors' (1, 2) step's loss within 1e-4 of
    one process's on the same checkpoint, and the whole state after it
    within 2e-2 leaf by leaf (each leaf's ‖Δ‖ / ‖x‖: bf16 gradients summed
    in another order; chip_smoke.py's ELASTIC_STATE_TOL), its step counter
    equal (bf16)."""
    survivors = [r["elastic"] for r in mesh_phase15 if not r["elastic"]["failed"]]
    assert len(survivors) == 2 and all(e["shape"] == [1, 2] for e in survivors)
    for e in survivors:
        assert abs(e["loss"] - e["loss_one_process"]) <= 1e-4 * abs(e["loss_one_process"])
        err = dict(e["state_err"])
        assert err.pop("step_equal") and max(err.values()) <= 2e-2, err


@pytest.fixture(scope="module")
def mesh_seq_decode(tmp_path_factory):
    """The partitioned decode step over a KV cache whose sequence splits
    over ``model``, on a (2, 2) mesh of four ranks on the one card
    (``tests/torch_mesh_cases.py:card_seq_decode``), run once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import pathlib

    from repro_torch.launch import mesh as mesh_mod

    work = tmp_path_factory.mktemp("mesh_seq")
    cases = pathlib.Path(__file__).resolve().parent / "torch_mesh_cases.py"
    return mesh_mod.run_ranks(4, f"{cases}:card_seq_decode", work, args=(work,), timeout=300)


@pytest.mark.cuda
def test_mesh_sequence_split_decode_on_card(mesh_seq_decode):
    """Reduced llama (fp32, tiled_csc) served into a 48-position cache on
    (2, 2): every rank keeps 4 rows × 24 positions × both KV heads, its
    greedy tokens equal one process's on the card and its logits lie
    within the fp32 tolerance of them (a fraction of the largest logit);
    each rank launched its local ``sod_matmul`` 2 layers × 7 projections
    × (the prefill + 4 steps) times."""
    for r in mesh_seq_decode:
        assert r["kv_shape"] == [2, 4, 24, 2, 32]
        assert r["tokens_equal"] and r["rel_err"] <= TOL[torch.float32], r
        assert r["launches"] == 2 * 7 * 5
