"""The traffic generator: a seed gives the same requests, every seed the
same multiset of lengths."""

import numpy as np
import pytest

from perfbench import spec, traffic

SEED = 2**31 + 12345  # a seed may pass 32 signed bits


def _sig(offers):
    return [(o.index, o.prompt.tolist(), o.max_new, o.due_s) for o in offers]


@pytest.mark.parametrize("mix", ["chat"])
def test_open_loop_repeats_from_its_seed(mix):
    m = spec.load_json(spec.traffic_file(mix))
    a = traffic.open_loop(m, SEED, 51, 49155)
    b = traffic.open_loop(m, SEED, 51, 49155)
    c = traffic.open_loop(m, SEED + 1, 51, 49155)
    assert _sig(a) == _sig(b)
    assert _sig(a) != _sig(c)
    # the same multisets of lengths and gaps, in another order
    for key in (lambda o: len(o.prompt), lambda o: o.max_new):
        assert sorted(map(key, a)) == sorted(map(key, c))
    assert len(a) == round(m["rate_per_s"] * 51)
    assert a[0].due_s == 0.0 and max(o.due_s for o in a) < 51
    # the arrival gaps are one set, whose sum offers the rate exactly
    span = len(a) / m["rate_per_s"]
    gaps = lambda offers: np.sort(np.diff([o.due_s for o in offers] + [span]))
    assert np.allclose(gaps(a), gaps(c))


@pytest.mark.parametrize("mix", ["decode-2k", "decode-4k"])
def test_closed_loop_repeats_from_its_seed(mix):
    m = spec.load_json(spec.traffic_file(mix))
    take = lambda s, n: [_sig([g.next()])[0] for g in [traffic.ClosedLoop(m, s, 32000)]
                         for _ in range(n)]
    assert take(SEED, 100) == take(SEED, 100)
    a = traffic.ClosedLoop(m, SEED, 32000)
    b = traffic.ClosedLoop(m, SEED + 7, 32000)
    ra = [a.next() for _ in range(96)]
    rb = [b.next() for _ in range(96)]
    c = m["clients"]
    for k in range(3):  # each round is one multiset
        sa, sb = ra[k * c:(k + 1) * c], rb[k * c:(k + 1) * c]
        assert sorted(o.max_new for o in sa) == sorted(o.max_new for o in sb)
        assert sorted(len(o.prompt) for o in sa) == sorted(len(o.prompt) for o in sb)
    lo, hi = m["output"]["min"], m["output"]["max"]
    # the first round is staggered over the residual life, the rest not
    assert min(o.max_new for o in ra[:c]) < lo
    assert all(lo <= o.max_new <= hi for o in ra[c:])
    assert all(m["prompt"]["min"] <= len(o.prompt) <= m["prompt"]["max"] for o in ra)
    # prompt, served tokens and the stop all fit the slots
    assert m["prompt"]["max"] + hi < m["max_len"] - 1


def test_quantiles_follow_the_distribution():
    logn = {"dist": "lognormal", "median": 96, "sigma": 0.6, "min": 16, "max": 512}
    q = traffic.quantiles(logn, 1001)
    assert q[500] == 96 and q.min() >= 16 and q.max() <= 512
    uni = {"dist": "uniform", "min": 8, "max": 32}
    assert sorted(set(traffic.quantiles(uni, 25).tolist())) == list(range(8, 33))
    r = traffic.residual_quantiles({"dist": "uniform", "min": 1024, "max": 2048}, 32)
    assert r.min() >= 1 and r.max() <= 2048
    # P(R <= 1024) = 1024 / E[L] = 1024 / 1536
    assert abs((r <= 1024).mean() - 2 / 3) < 0.05


def test_chat_mix_fits_its_slots():
    m = spec.load_json(spec.traffic_file("chat"))
    assert m["prompt"]["max"] + m["output"]["max"] < m["max_len"] - 1


def test_chat_lengths_follow_their_source():
    """LMSYS-Chat-1M's means (69.5 tokens a prompt, 214.5 a response)
    within 2%, and every 16 consecutive requests hold one length of each
    sixteenth of each distribution."""
    m = spec.load_json(spec.traffic_file("chat"))
    n = round(m["rate_per_s"] * 51)
    assert abs(traffic.quantiles(m["prompt"], n).mean() / 69.5 - 1) < 0.02
    assert abs(traffic.quantiles(m["output"], n).mean() / 214.5 - 1) < 0.02
    offers = traffic.open_loop(m, SEED, 51, 49155)
    s = m["strata"]
    for key, dist in ((lambda o: len(o.prompt), m["prompt"]), (lambda o: o.max_new,
                                                                m["output"])):
        strata = np.array_split(np.sort(traffic.quantiles(dist, n)), s)
        for k in range(0, n - s + 1, s):
            run = sorted(key(o) for o in offers[k:k + s])
            assert all(g[0] <= v <= g[-1] for g, v in zip(strata, run)), (k, run)
