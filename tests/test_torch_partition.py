"""The partitioned program's pieces that need no ranks, on one process: the
MoE block's global first-come slots from per-rank histograms
(:func:`repro_torch.models.moe.first_come_slots`, :func:`block_hist`)
against the reference's ``_rank_in_expert`` of each whole block, and the
audio model's codebook-blocked cross-entropy and embedding
(:mod:`repro_torch.models.layers`) against the whole ones, every rank's
share computed here and combined as the collectives would."""
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import layers, moe


@pytest.mark.parametrize("n_ranks,nb", [(1, 1), (4, 1), (4, 2), (4, 4), (4, 8), (2, 3),
                                         (8, 2), (3, 4)])
def test_global_first_come_slots_from_histograms(n_ranks, nb):
    """Every rank's slots (its rank in its (block, expert) among its own
    tokens, plus the earlier ranks' counts of the same block and expert
    from their all-gathered histograms) equal the reference's
    ``_rank_in_expert`` over each whole block of the concatenated
    assignments: blocks inside one rank, blocks that span several, and a
    rank whose rows span several blocks."""
    e, k, t_rank = 8, 2, 24
    t = n_ranks * t_rank
    tb = t // nb
    rng = np.random.default_rng(n_ranks * 10 + nb)
    ids = np.stack([rng.choice(e, size=k, replace=False) for _ in range(t)])
    want = np.concatenate([np.asarray(jmoe._rank_in_expert(block, e))
                           for block in ids.reshape(nb, tb * k)])
    ranks = [torch.from_numpy(ids[r * t_rank:(r + 1) * t_rank]) for r in range(n_ranks)]
    hists = torch.stack([moe.block_hist(x, e, r * t_rank, tb, nb) for r, x in enumerate(ranks)])
    got, blocks = [], []
    for r, x in enumerate(ranks):
        before = hists[:r].sum(0) if nb % n_ranks else None
        b, slot = moe.first_come_slots(x, e, r * t_rank, tb, before)
        got.append(slot)
        blocks.append(b)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), np.arange(t * k) // (tb * k))
    assert int(hists.sum()) == t * k


# (model size, codebooks, padded vocab): whole codebooks a rank, one, half,
# a quarter of one (musicgen's 4 × 2048 over 16)
BLOCKS = [(2, 4, 64), (4, 4, 64), (8, 4, 64), (16, 4, 128)]


@pytest.mark.parametrize("tp,c,v", BLOCKS)
def test_codebook_blocked_cross_entropy(tp, c, v):
    """Each rank's block of the (B, S, C · V) logits (:func:`codebook_block`),
    its per-codebook max, then its sums of exponentials and target logits
    (:func:`codebook_max`, :func:`codebook_sums`), combined over the ranks
    as ``pmax`` and ``psum`` combine them, give the masked mean
    cross-entropy of the whole logits (float32)."""
    rng = np.random.default_rng(tp)
    logits = torch.from_numpy(rng.standard_normal((2, 5, c, v)).astype(np.float32) * 3)
    targets = torch.from_numpy(rng.integers(0, v, (2, 5, c)))
    mask = torch.ones(2, 5, c)
    mask.view(-1)[::4] = 0
    want = layers.cross_entropy(logits, targets, mask)
    cols = c * v // tp
    flat = logits.reshape(2, 5, c * v)
    blocks = [layers.codebook_block(cols, c, v, index=r) for r in range(tp)]
    parts = [flat[..., r * cols:(r + 1) * cols].reshape(2, 5, blk[1], blk[3])
             for r, blk in enumerate(blocks)]
    top = torch.stack([layers.codebook_max(p, blk, c) for p, blk in zip(parts, blocks)]).amax(0)
    sumexp, gold = sum(layers.codebook_sums(p, targets, blk, c, top)
                       for p, blk in zip(parts, blocks))
    nll = top + torch.log(sumexp) - gold
    got = (nll * mask).sum() / mask.sum()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    assert all(blk[1] * blk[3] == cols for blk in blocks)


@pytest.mark.parametrize("tp,c,v", BLOCKS)
def test_codebook_blocked_embedding(tp, c, v):
    """The C lookups of every rank's vocabulary block of each codebook's
    table (:func:`codebook_rows`), summed over the ranks and then added in
    codebook order, equal :func:`embed_codebooks` on the whole tables, bit
    for bit."""
    rng = np.random.default_rng(tp + 100)
    tables = torch.from_numpy(rng.standard_normal((c, v, 16)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, v, (3, 7, c)))
    rows = v // tp
    xs = sum(layers.codebook_rows(tables[:, r * rows:(r + 1) * rows], tokens, r * rows)
             for r in range(tp))
    got = sum(xs[i] for i in range(c))
    assert torch.equal(got, layers.embed_codebooks(tables, tokens, v))
