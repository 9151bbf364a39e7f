"""The closed-loop generator (``traffic/closed_loop.py``, found by the mix's
``kind``): seeded, deterministic, every seed the same work in another
order, and the distributions the mix states."""
from __future__ import annotations

import collections
import math

import numpy as np
import pytest

from perfbench.harness import spec, traffic

VOCAB = 1000


def _closed(mix, seed, seconds=30.0):
    return spec.traffic_kind(mix).Plan(mix, seed, seconds, VOCAB)


def _schedule(plan, clients, per_client=6):
    """Each client's first request and its next ``per_client`` ones."""
    rows = []
    for c in range(clients):
        first = plan.first[c]
        rows.append(((first.prompt_len, first.max_new),) + tuple(
            (r.prompt_len, r.max_new) for r in (plan.next_closed(c) for _ in range(per_client))))
    return rows


def test_the_mix_names_its_kind():
    mix = spec.traffic("closed_decode128")
    assert mix["kind"] == "closed_loop"
    assert spec.traffic_kind(mix) is spec.traffic_kind(dict(mix))        # loaded once
    assert hasattr(spec.traffic_kind(mix), "drive")


@pytest.mark.parametrize("seed", [2**31 + 17, 0])
def test_same_seed_same_requests(seed):
    mix = spec.traffic("closed_decode128")
    a, b = _closed(mix, seed), _closed(mix, seed)
    assert a.first == b.first
    assert _schedule(a, 8) == _schedule(b, 8)
    for r in a.first[:5]:
        assert np.array_equal(a.tokens(r), b.tokens(r))


def test_closed_seeds_deal_one_schedule():
    """Two seeds give the clients the same rows in another order, and
    other token ids."""
    mix = spec.traffic("closed_decode128")
    a, b = _closed(mix, 5), _closed(mix, 2**40 + 3)
    sa, sb = _schedule(a, mix["clients"]), _schedule(b, mix["clients"])
    assert collections.Counter(sa) == collections.Counter(sb)
    assert sa != sb
    assert not np.array_equal(a.tokens(a.first[0]), b.tokens(b.first[0]))


def test_closed_lengths_follow_the_mix():
    mix = spec.traffic("closed_decode128")
    plan = _closed(mix, 9)
    c, cyc = mix["clients"], mix["cycle"]
    rows = [plan.next_closed(i) for i in range(c) for _ in range(cyc)]
    p = np.array([r.prompt_len for r in rows])
    o = np.array([r.max_new for r in rows])
    assert p.min() >= 64 and p.max() <= 512 and o.min() >= 128 and o.max() <= 512
    assert abs(np.median(p) - 160) <= 2 and abs(np.median(o) - 256) <= 2
    # heavy right tail: the log-normal's mean lies above its median
    assert p.mean() > np.median(p) and o.mean() > np.median(o)
    # the means the mix's file states beside its source's
    assert p.mean() == pytest.approx(188.5, abs=0.1) and o.mean() == pytest.approx(280.0, abs=0.1)
    # a client's row cycles
    again = [plan.next_closed(0) for _ in range(cyc)]
    assert [(r.prompt_len, r.max_new) for r in again] == \
        [(r.prompt_len, r.max_new) for r in rows[:cyc]]
    # every request index is new
    assert len({r.idx for r in rows + again + plan.first}) == len(rows) + len(again) + c
    # a prompt and its output fit one row of the engine
    assert p.max() + o.max() <= mix["engine"]["max_len"]


def test_first_outputs_are_the_length_biased_residual():
    """A request caught at a random moment has E[R] = E[L(L+1)] / (2 E[L])
    tokens left."""
    mix = spec.traffic("closed_decode128")
    plan = _closed(mix, 3)
    base = traffic.quantile_lengths(mix["output_len"], mix["clients"] * mix["cycle"])
    want = (base * (base + 1)).mean() / (2 * base.mean())
    got = np.mean([r.max_new for r in plan.first])
    assert abs(got - want) / want < 0.03
    assert min(r.max_new for r in plan.first) >= 1


def test_quantile_lengths_are_the_lognormal():
    spec_ = {"median": 100, "sigma": 0.5, "min": 1, "max": 10**6}
    q = traffic.quantile_lengths(spec_, 1001)
    assert q[500] == 100
    assert abs(q[841] - 100 * math.exp(0.5)) <= 1.5     # one sigma up


def test_prompt_ids_differ_between_requests():
    mix = spec.traffic("closed_decode128")
    plan = _closed(mix, 11)
    a, b = plan.first[0], plan.first[1]
    ta, tb = plan.tokens(a), plan.tokens(b)
    assert len(ta) == a.prompt_len and ta.min() >= 0 and ta.max() < VOCAB
    n = min(len(ta), len(tb))
    assert not np.array_equal(ta[:n], tb[:n])
