"""The port's footprint formats and layerwise profiles against the JAX package.

``density``, ``Bitmap`` / ``pack_bitmap``, the pointer CSC (``pack_csc``,
``unpack_csc``, ``csc_nbytes``), ``TiledCSC.compression_ratio``,
``PAPER_PROFILES`` and ``prune_tree`` on the same seeded inputs in both
packages.  Everything here is exact: masks, values, byte counts and pruned
leaves bit for bit (float32 weights), and the names a callable density and
a path filter are handed equal the reference's, in its order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import formats as jformats
from repro.core import pruning as jpruning
from repro.models.model import LM as JLM
from repro_torch import configs
from repro_torch.core import formats, pruning
from repro_torch.core.tree import leaves_with_path
from repro_torch.interop import params_from_numpy

DENSITIES = (0.05, 0.3, 0.7, 1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The small CPU ops gain nothing from intra-op threads; the suite's
    parallel workers would contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sparse(shape, density: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    return np.where(rng.uniform(size=shape) < density, w, 0).astype(np.float32)


@pytest.mark.parametrize("d", DENSITIES)
def test_density_equals_the_reference(d):
    w = _sparse((96, 200), d, seed=int(d * 100))
    assert formats.density(torch.from_numpy(w)) == jformats.density(w)
    assert formats.density(w) == jformats.density(w)
    assert formats.density(np.zeros((0, 3))) == jformats.density(np.zeros((0, 3))) == 0.0


@pytest.mark.parametrize("cap", [None, 1, 50, 5000])
@pytest.mark.parametrize("d", (0.05, 0.4))
def test_bitmap_equals_the_reference(d, cap):
    w = _sparse((48, 72), d, seed=7)
    ours = formats.pack_bitmap(torch.from_numpy(w), cap=cap)
    ref = jformats.pack_bitmap(jnp.asarray(w), cap=cap)
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(ours.vals.numpy(), np.asarray(ref.vals))
    assert ours.shape == ref.shape
    for bits in (8, 16, 32):
        assert ours.nbytes_compressed(bits) == ref.nbytes_compressed(bits)
        assert ours.nbytes_dense(bits) == ref.nbytes_dense(bits)
    np.testing.assert_array_equal(ours.to_dense().numpy(), np.asarray(ref.to_dense()))
    if cap is None:
        np.testing.assert_array_equal(ours.to_dense().numpy(), w)


@pytest.mark.parametrize("shape,d", [((64, 40), 0.3), ((17, 33), 0.05), ((8, 8), 0.0)])
def test_pointer_csc_equals_the_reference(shape, d):
    w = _sparse(shape, d, seed=11)
    ours, ref = formats.pack_csc(torch.from_numpy(w)), jformats.pack_csc(w)
    assert ours.keys() == ref.keys()
    for key in ref:
        assert ours[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(ours[key], ref[key])
    np.testing.assert_array_equal(formats.unpack_csc(ours), w)
    assert formats.pack_csc(w).keys() == ref.keys()
    for bits in [(16, 8, 32), (8, 4, 16), (32, 16, 64), (4, 8, 32)]:
        assert formats.csc_nbytes(ours, *bits) == jformats.csc_nbytes(ref, *bits)


@pytest.mark.parametrize("tile", [(128, 128), (64, 32)])
@pytest.mark.parametrize("d", (0.1, 0.3, 0.9))
def test_compression_ratio_equals_the_reference(d, tile):
    w = _sparse((300, 260), d, seed=3)
    ours = formats.pack_tiled_csc(torch.from_numpy(w), tile=tile)
    ref = jformats.pack_tiled_csc(jnp.asarray(w), tile=tile)
    assert ours.compression_ratio() == ref.compression_ratio()
    assert (ours.nbytes_compressed(), ours.nbytes_dense()) == (
        ref.nbytes_compressed(), ref.nbytes_dense())


def test_profiles_equal_the_reference():
    assert list(pruning.PAPER_PROFILES) == list(jpruning.PAPER_PROFILES)
    for name, prof in pruning.PAPER_PROFILES.items():
        ref = jpruning.PAPER_PROFILES[name]
        assert dataclasses.asdict(prof) == dataclasses.asdict(ref)
        assert [prof.density_for_layer(i) for i in range(30)] == [
            ref.density_for_layer(i) for i in range(30)]
    assert [f.name for f in dataclasses.fields(pruning.SparsityProfile)] == [
        f.name for f in dataclasses.fields(jpruning.SparsityProfile)]


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port config): the reduced llama's JAX weights in
    float32."""
    jcfg = jconfigs.reduced(jconfigs.get_config("llama3.2-1b")).with_(dtype="float32")
    tcfg = configs.reduced(configs.get_config("llama3.2-1b")).with_(dtype="float32")
    return JLM(jcfg).init(jax.random.PRNGKey(5)), tcfg


def _port(tree, tcfg) -> dict:
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), tcfg, device="cpu")


def _profile_density():
    prof = pruning.PAPER_PROFILES["bert_squad"]
    return lambda name: prof.density_for_layer(len(name))


@pytest.mark.parametrize("density", ["constant", "profile"])
@pytest.mark.parametrize("method", ["magnitude", "block", "nm"])
def test_prune_tree_equals_the_reference(weights, method, density):
    """Every leaf bit for bit; the callable density sees the reference's
    names in the reference's order."""
    jparams, tcfg = weights
    seen = {"ref": [], "ours": []}

    def make(side):
        if density == "constant":
            return 0.3
        fn = _profile_density()
        return lambda name: (seen[side].append(name), fn(name))[1]

    want = _port(jpruning.prune_tree(jparams, make("ref"), method=method), tcfg)
    got = pruning.prune_tree(_port(jparams, tcfg), make("ours"), method=method)
    got_leaves, want_leaves = dict(leaves_with_path(got)), dict(leaves_with_path(want))
    assert got_leaves.keys() == want_leaves.keys()
    for path, leaf in want_leaves.items():
        assert torch.equal(got_leaves[path], leaf), path
    assert seen["ours"] == seen["ref"]
    if density == "profile":
        assert ".blocks.attn.wq" in seen["ref"] and ".embed" in seen["ref"]
    pruned = got_leaves["['layers'][0]['attn']['wq']"]
    assert 0 < float((pruned != 0).float().mean()) < 1


def test_prune_tree_path_filter_sees_the_reference_names(weights):
    jparams, tcfg = weights
    seen = {"ref": [], "ours": []}

    def keep(side):
        return lambda name: (seen[side].append(name), ".mlp." in name)[1]

    want = _port(jpruning.prune_tree(jparams, 0.25, path_filter=keep("ref")), tcfg)
    got = pruning.prune_tree(_port(jparams, tcfg), 0.25, path_filter=keep("ours"))
    assert seen["ours"] == seen["ref"] and len(seen["ref"]) > 3
    src = dict(leaves_with_path(_port(jparams, tcfg)))
    for path, leaf in leaves_with_path(want):
        ours = dict(leaves_with_path(got))[path]
        assert torch.equal(ours, leaf), path
        assert torch.equal(ours, src[path]) == ("['mlp']" not in path), path


def test_movement_pruning_raises_in_both_packages(weights):
    jparams, tcfg = weights
    with pytest.raises(ValueError, match="unknown pruning method"):
        jpruning.prune_tree(jparams, 0.3, method="movement")
    with pytest.raises(ValueError, match="unknown pruning method"):
        pruning.prune_tree(_port(jparams, tcfg), 0.3, method="movement")
