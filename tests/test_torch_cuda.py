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
