"""The recurrent families' partitioned program on one process (no ranks):
the gated norm's statistics summed from column blocks, and the decode
state's specs read from the families' own cache axes.

The norm: ``layers.sum_squares`` of each of k column blocks, summed, then
``layers.rms_from_sum`` on each block, against ``layers.rms_norm`` on the
whole width (fp32, within 1e-6: the blocks' sums are added in another
order).  The specs: ``sharding.decode_cache_specs`` on the hybrid's and the
xLSTM's zeroed caches (meta tensors) where the layer groups G, the blocks
a group P or n_m, or both, equal the batch, and on an attention cache
whose layers L do, so a rule that looked for the batch by its size would
pick the wrong dim.
"""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers
from repro_torch.models.model import LM
from repro_torch.runtime import sharding

NORM_TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("blocks", [1, 2, 4, 8])
def test_split_rms_norm_statistics_from_column_blocks(blocks):
    rng = np.random.default_rng(blocks)
    x = torch.from_numpy(rng.standard_normal((3, 5, 256)).astype(np.float32)) * 3
    gamma = torch.from_numpy(rng.standard_normal(256).astype(np.float32)) * 0.1
    xs, gs = x.chunk(blocks, -1), gamma.chunk(blocks)
    total = sum(layers.sum_squares(b) for b in xs)
    got = torch.cat([layers.rms_from_sum(b, g, total, 256) for b, g in zip(xs, gs)], -1)
    np.testing.assert_allclose(got.numpy(), layers.rms_norm(x, gamma).numpy(), **NORM_TOL)
    # outside a partitioned step the split norm is the whole one, bit for bit
    assert torch.equal(layers.split_rms_norm(x, gamma, 256), layers.rms_norm(x, gamma))


def _cache(arch, batch, **fields):
    cfg = configs.reduced(configs.get_config(arch)).with_(**fields)
    return cfg, LM(cfg).init_cache(batch, 16, "meta")


# case -> (arch, config fields, batch, mesh): G (the groups) and P (Mamba2
# blocks a group) or n_m (mLSTM blocks a group) equal to the batch
CASES = {
    "hybrid_g_p": ("zamba2-2.7b", {"n_layers": 12, "hybrid_attn_every": 6}, 2, (2, 2)),
    "hybrid_p": ("zamba2-2.7b", {"n_layers": 8, "hybrid_attn_every": 4}, 4, (4, 2)),
    "xlstm_g_nm": ("xlstm-125m", {"n_layers": 8, "slstm_every": 4}, 2, (2, 2)),
    "xlstm_nm": ("xlstm-125m", {"n_layers": 12, "slstm_every": 4}, 3, (1, 4)),
    # an attention cache (L, B, S, KV, hd) whose L equals the batch
    "dense_l": ("llama3.2-1b", {"n_layers": 4}, 4, (4, 2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_cache_specs_read_the_family_axes(case):
    """Rows over ``data`` at the batch axis ``cache_spec()`` names (where
    the batch divides it), heads over ``model`` where they divide it: the
    Mamba2 state at H and ``conv.x`` at its channels, mLSTM's ``c``, ``n``,
    ``m`` at H; ``conv.b``, ``conv.c``, the mLSTM conv and sLSTM's state
    rows only.  A KV leaf's 16 positions divide ``model``, so its sequence
    axis splits over ``model`` (the reference's ``seq_shard``); with
    ``seq_shard=False`` its KV heads do where they divide it."""
    arch, fields, batch, shape = CASES[case]
    cfg, cache = _cache(arch, batch, **fields)
    mesh = mesh_mod.AbstractMesh(shape, ("data", "model"))
    specs = sharding.decode_cache_specs(cache, cfg, mesh, batch)
    whole_seq = sharding.decode_cache_specs(cache, cfg, mesh, batch, seq_shard=False)
    rows = "data" if batch % shape[0] == 0 else None
    tp = shape[1]
    if cfg.family in ("dense", "hybrid"):
        kv = "model" if cfg.n_kv_heads % tp == 0 else None
        assert specs["k"] == specs["v"] == (None, rows, "model", None, None)
        assert whole_seq["k"] == whole_seq["v"] == (None, rows, None, kv, None)
    if cfg.family == "dense":
        assert cache["k"].shape[0] == batch
        return
    if cfg.family == "hybrid":
        heads = "model" if (2 * cfg.d_model // cfg.ssm_headdim) % tp == 0 else None
        assert specs["ssm"] == whole_seq["ssm"] == (None, None, rows, heads, None, None)
        assert specs["conv"] == whole_seq["conv"] == {"x": (None, None, rows, None, heads),
                                                      "b": (None, None, rows, None, None),
                                                      "c": (None, None, rows, None, None)}
    else:
        heads = "model" if cfg.n_heads % tp == 0 else None
        assert specs == whole_seq
        assert specs["mlstm"] == {"c": (None, None, rows, heads, None, None),
                                  "n": (None, None, rows, heads, None),
                                  "m": (None, None, rows, heads),
                                  "conv": (None, None, rows, None, None)}
        assert specs["slstm"] == ((None, rows, None, None),) * 4
    # the leaves' sizes that a size match would take for the batch
    lead = cache["ssm"].shape[:2] if cfg.family == "hybrid" else cache["mlstm"]["c"].shape[:2]
    assert batch in lead


def test_decode_cache_specs_place_the_rank_block():
    """Under the specs rank (1, 1) of (2, 2) holds its rows and heads of a
    hybrid cache whose G equals the batch (``place`` on the counting mesh
    for the shapes; its block of a CPU cache for the values), as the
    partitioned decode step keeps them."""
    cfg, _ = _cache("zamba2-2.7b", 2, n_layers=12, hybrid_attn_every=6)
    cache = LM(cfg).init_cache(2, 8, "cpu")
    cache["ssm"].copy_(torch.arange(cache["ssm"].numel(), dtype=torch.float32)
                       .reshape(cache["ssm"].shape))
    mesh = mesh_mod.DryMesh((2, 2), ("data", "model"), rank=3)
    specs = sharding.decode_cache_specs(cache, cfg, mesh, 2)
    placed = sharding.place(cache, specs, mesh)
    h = cache["ssm"].shape[3] // 2
    want = cache["ssm"][:, :, 1:2, h:]
    assert placed["ssm"].shape == want.shape
    assert torch.equal(sharding._block_nd(cache["ssm"], mesh, specs["ssm"]), want)
    assert placed["conv"]["b"].shape == cache["conv"]["b"][:, :, 1:2].shape
    assert placed["conv"]["x"].shape[-1] == cache["conv"]["x"].shape[-1] // 2


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_zero1_gives_every_recurrent_leaf_its_block(arch):
    """On (4, 2) every leaf of the Mamba2, mLSTM and sLSTM stacks has the
    reference's parameter spec and, under ZeRO-1, its moments split over
    ``data`` on the first dim the parameter's spec leaves whole and 4
    divides (``_zero_spec`` on the port's own leaf shape); a leaf with no
    such dim stays as its parameter lies."""
    from repro_torch.core.tree import leaves_with_path
    from repro_torch.optim.adamw import AdamW, AdamWConfig

    cfg = configs.reduced(configs.get_config(arch))
    params = LM(cfg).init(torch.Generator().manual_seed(0), "cpu")
    mesh = mesh_mod.AbstractMesh((4, 2), ("data", "model"))
    specs = sharding.param_specs(params, cfg, mesh)
    o_specs = sharding.opt_state_specs(AdamW(AdamWConfig()).init(params), specs, mesh, cfg=cfg)
    stacks = ("mamba_blocks", "mlstm_blocks", "slstm_blocks")
    found = 0
    leaves = list(leaves_with_path(params))
    p_items, m_items = list(_spec_items(specs)), list(_spec_items(o_specs["m"]))
    assert [k for k, _ in leaves] == [k for k, _ in p_items] == [k for k, _ in m_items]
    for (path, p), (_, ps), (_, ms) in zip(leaves, p_items, m_items):
        if not path.startswith(tuple(f"['{k}']" for k in stacks)):
            continue
        found += 1
        ps = tuple(ps) + (None,) * (p.ndim - len(tuple(ps)))
        free = [i for i, (d, ax) in enumerate(zip(p.shape, ps)) if ax is None and d % 4 == 0]
        want = list(ps)
        if free:
            want[free[0]] = "data"
        assert tuple(ms) == tuple(want), (path, p.shape, ps, ms)
    assert found > 0


def _spec_items(specs, path=""):
    """``(path, spec tuple)`` of a spec tree, in the walk order of
    ``leaves_with_path``."""
    if isinstance(specs, dict):
        for k, v in specs.items():
            yield from _spec_items(v, f"{path}[{k!r}]")
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _spec_items(v, f"{path}[{i}]")
    else:
        yield path, specs
