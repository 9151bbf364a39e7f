"""The port's MoE block (``repro_torch.models.moe``) against the JAX package's.

The same numpy inputs from a seed, and the reference's float32 weights
(``repro.models.moe.init_moe``) carried across, go through
``repro.models.moe.moe_mlp`` and the port's, on the CPU in float32.
Tolerance: the output within 1e-5 of the reference output's largest
magnitude (float32 sums in another order), the aux loss rtol 1e-5, and
the gradients of a scalar of both with respect to x, the router, the
routed experts (and the shared expert's leaves) within 1e-5 of each
gradient's largest magnitude; the routing itself (top-k ids, ranks in the
expert, drops) is exact, so every case also compares the chosen experts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.interop import to_torch
from repro_torch.models import moe

REL = 1e-5
D, F = 32, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops gain nothing from intra-op threads, and under the
    suite's parallel workers every worker's threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# case -> (spec fields, x shape, zero router)
CASES = {
    "base": (dict(n_experts=8, n_experts_padded=8, top_k=2), (2, 16), False),
    "padded_6_to_8": (dict(n_experts=6, n_experts_padded=8, top_k=2), (2, 16), False),
    "one_expert_top1": (dict(n_experts=1, n_experts_padded=1, top_k=1,
                             capacity_factor=8.0), (1, 8), False),
    "forced_drops": (dict(n_experts=8, n_experts_padded=8, top_k=2,
                          capacity_factor=0.01), (2, 256), False),
    "dispatch_blocks_2": (dict(n_experts=8, n_experts_padded=8, top_k=2,
                               dispatch_blocks=2), (2, 16), False),
    "dispatch_blocks_fallback": (dict(n_experts=8, n_experts_padded=8, top_k=2,
                                      dispatch_blocks=3), (2, 16), False),
    "shared_expert": (dict(n_experts=8, n_experts_padded=8, top_k=2, n_shared=1,
                           d_shared_ff=F), (2, 16), False),
    "qwen_like": (dict(n_experts=60, n_experts_padded=64, top_k=4, n_shared=4,
                       d_shared_ff=2 * F), (2, 24), False),
    "zero_router_ties": (dict(n_experts=6, n_experts_padded=8, top_k=3), (2, 16), True),
}


def _specs(fields):
    kw = dict(d_model=D, d_ff=F, **fields)
    return jmoe.MoESpec(**kw), moe.MoESpec(**kw)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return to_torch(np.asarray(tree), "cpu")


def _setup(case: str, seed: int = 0):
    fields, (b, s), zero_router = CASES[case]
    jspec, tspec = _specs(fields)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jspec, dtype=jnp.float32)
    if zero_router:
        jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    x = np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)
    return jspec, tspec, jp, _to_torch(jp), x


def _ref_ids(jp, x, jspec):
    """The reference's top-k expert ids (T, K), as ``moe_mlp`` picks them."""
    xt = jnp.asarray(x).reshape(-1, D)
    logits = jnp.dot(xt, jp["router"], preferred_element_type=jnp.float32)
    if jspec.n_experts_padded > jspec.n_experts:
        logits = jnp.where(jnp.arange(jspec.n_experts_padded) >= jspec.n_experts,
                           -1e30, logits)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, -1), jspec.top_k)[1])


def _assert_close(got, want, err_msg=""):
    want = np.asarray(want)
    atol = REL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0,
                               err_msg=err_msg)


@pytest.mark.parametrize("case", CASES)
def test_moe_mlp_matches_reference(case):
    jspec, tspec, jp, tp, x = _setup(case)
    want, want_aux = jmoe.moe_mlp(jp, jnp.asarray(x), jspec)
    got, aux = moe.moe_mlp(tp, to_torch(x, "cpu"), tspec)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert aux.dtype == torch.float32 and aux.ndim == 0
    _assert_close(got.numpy(), want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=REL)
    assert np.isfinite(got.numpy()).all() and float(aux) >= 0.0


@pytest.mark.parametrize("case", CASES)
def test_routing_matches_reference(case):
    """The port's top-k picks the reference's experts in the reference's
    order (ties: the lower index first) and never a padded expert."""
    jspec, tspec, jp, tp, x = _setup(case)
    want = _ref_ids(jp, x, jspec)
    xt = to_torch(x, "cpu").reshape(-1, D)
    probs = torch.softmax(moe.router_logits(tp, xt, tspec), -1)
    _, ids = moe._top_k(probs, tspec.top_k)
    np.testing.assert_array_equal(ids.numpy(), want)
    assert int(ids.max()) < tspec.n_experts
    if CASES[case][2]:
        assert (want == np.arange(tspec.top_k)).all()


def test_forced_drops_happen():
    """The drop case really drops: some expert gets more assignments than
    its capacity, so the drop bin and the zeroed weights are exercised."""
    jspec, tspec, jp, _, x = _setup("forced_drops")
    counts = np.bincount(_ref_ids(jp, x, jspec).reshape(-1), minlength=8)
    assert counts.max() > tspec.capacity(x.shape[0] * x.shape[1])


GRAD_CASES = ("base", "padded_6_to_8", "forced_drops", "dispatch_blocks_2",
              "shared_expert", "zero_router_ties")


@pytest.mark.parametrize("case", GRAD_CASES)
def test_gradients_match_jax_grad(case):
    """d(sum(y · c) + aux) with respect to x and every weight leaf, against
    ``jax.grad`` of the reference."""
    jspec, tspec, jp, tp, x = _setup(case)
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jloss(params, xx):
        y, aux = jmoe.moe_mlp(params, xx, jspec)
        return jnp.sum(y * cot) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = to_torch(x, "cpu").requires_grad_(True)
    leaves = {}

    def live(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = live(v, f"{prefix}{k}.")
            else:
                out[k] = leaves[prefix + k] = v.clone().requires_grad_(True)
        return out

    y, aux = moe.moe_mlp(live(tp), xt, tspec)
    (torch.sum(y * to_torch(cot, "cpu")) + aux).backward()
    _assert_close(xt.grad.numpy(), jgx, "x")
    for name, leaf in leaves.items():
        node = jgp
        for part in name.split("."):
            node = node[part]
        _assert_close(leaf.grad.numpy(), node, name)
    assert float(leaves["router"].grad.abs().max()) > 0


@pytest.mark.parametrize("e", [1, 6, 8, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_rank_in_expert_matches_reference(e, seed):
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, e, size=(96,)).astype(np.int32)
    want = np.asarray(jmoe._rank_in_expert(jnp.asarray(assign), e))
    got = moe._rank_in_expert(torch.from_numpy(assign).long(), e)
    np.testing.assert_array_equal(got.numpy(), want)
    blocks = moe._rank_in_expert(torch.from_numpy(assign).long().reshape(3, 32), e)
    for i in range(3):
        np.testing.assert_array_equal(
            blocks[i].numpy(), np.asarray(jmoe._rank_in_expert(
                jnp.asarray(assign.reshape(3, 32)[i]), e)))


@pytest.mark.parametrize("n,ep", [(60, 16), (32, 16), (7, 4), (8, 4), (1, 16), (64, 16)])
def test_pad_experts_matches_reference(n, ep):
    assert moe.pad_experts(n, ep) == jmoe.pad_experts(n, ep)


@pytest.mark.parametrize("fields", [dict(n_experts=32, top_k=8), dict(n_experts=60, top_k=4),
                                    dict(n_experts=8, top_k=2, capacity_factor=0.01)])
def test_capacity_matches_reference(fields):
    jspec, tspec = _specs(dict(n_experts_padded=64, **fields))
    for t in (1, 4, 16, 64, 128, 409, 410, 1024, 4096):
        assert tspec.capacity(t) == jspec.capacity(t)
        assert tspec.capacity(t) % 128 == 0 and tspec.capacity(t) >= 128


def test_packed_routed_experts_raise():
    """Fault R4, kept: a packed routed expert is refused with its name."""
    from repro_torch.core import formats
    _, tspec, _, tp, x = _setup("base")
    tp["w_up"] = formats.pack_tiled_csc(tp["w_up"], tile=(32, 32))
    with pytest.raises(ValueError, match="R4"):
        moe.moe_mlp(tp, to_torch(x, "cpu"), tspec)
