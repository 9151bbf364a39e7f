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
