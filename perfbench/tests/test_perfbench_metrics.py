"""The metric arithmetic: end-to-end numbers from the client-side stamps,
the per-layer readers, the decode-call log, FLOPs and the kernel bound."""

import numpy as np
import pytest

from perfbench import flops, harness, peaks, spec, traffic


def _offer(i, due, n_prompt=4, n_out=3):
    return traffic.Offer(i, np.zeros(n_prompt, np.int32), n_out, due)


def _rec(i, due, times, t0=100.0):
    r = harness.Rec(_offer(i, due), due=t0 + due)
    r.times = [t0 + t for t in times]
    return r


def test_end_to_end_from_due_times_over_the_whole_window():
    t0 = 100.0
    recs = {
        0: _rec(0, 0.0, [0.5, 0.5, 1.5]),       # ttft 0.5; gaps 0, 1.0
        1: _rec(1, 1.0, [3.0, 4.0, 11.0]),      # ttft 2.0; last token after the end
        2: _rec(2, 9.0, []),                    # no token: counts end - due = 1.0
    }
    offers = [r.offer for r in recs.values()] + [_offer(3, 9.5)]  # never sent: 0.5
    win = harness.Window(t0=t0, end=t0 + 10.0, recs=recs, offers=offers,
                         decode_calls=40, steps_log=[], trace=None)
    e = harness.end_to_end(win, open_loop=True)
    assert e["tokens"] == 5  # tokens received within (t0, end]
    assert e["tokens_per_s"] == pytest.approx(0.5)
    assert e["ttft_mean_ms"] == pytest.approx(1e3 * (0.5 + 2.0 + 1.0 + 0.5) / 4)
    # gaps pooled over requests: 0, 1.0 (req 0) and 1.0 (req 1)
    assert e["gaps"] == 3
    assert e["itl_p95_ms"] == pytest.approx(1e3 * np.percentile([0, 1.0, 1.0], 95))


def test_closed_loop_has_no_ttft_and_counts_tokens_in_the_window_only():
    t0 = 0.0
    recs = {0: _rec(0, -5.0, [-1.0, 0.5, 1.0, 2.0], t0=t0)}
    win = harness.Window(t0=t0, end=1.5, recs=recs, offers=[], decode_calls=3,
                         steps_log=[], trace=None)
    e = harness.end_to_end(win, open_loop=False)
    assert "ttft_mean_ms" not in e
    assert e["tokens"] == 2 and e["gaps"] == 2  # 0.5 (from the set-up token), 0.5


def _run(**kw):
    base = dict(window_s=10.0, tokens_out=400, n_slots=16, decode_calls=500,
                planned_bytes=3 * 2**20, model_flops=9.89e12,
                peak_flops=989e12,
                trace={"window_s": 2.0, "busy_s": 1.5, "device_s": 1.6,
                       "decode_calls": 100, "fd_s": 0.2, "fd_bound_s": 0.05})
    base.update(kw)
    return harness.RunRecord(**base)


@pytest.mark.parametrize("name,want", [
    ("slot_use_pct", 100 * 400 / (500 * 16)),
    ("wave_ms", 1e3 * 10 / 500),
    ("wave_device_ms", 16.0),
    ("flash_decode_roofline", 25.0),
    ("mfu_pct", 0.1),
    ("device_idle_pct", 25.0),
    ("planned_mib", 3.0),
])
def test_readers(name, want):
    assert spec.metric_reader(name)(_run()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["wave_device_ms", "flash_decode_roofline",
                                  "device_idle_pct"])
def test_readers_of_the_trace_find_nothing_without_one(name):
    assert spec.metric_reader(name)(_run(trace=None)) is None


def test_the_decode_log_expands_block_waves():
    pos = np.array([10, 3, 7])
    active = np.array([True, True, False])
    budget = np.array([8, 2, 0])
    steps = list(harness.expand([("block", pos, active, budget, 4),
                                 ("step", pos, np.array([False, False, True]), None, 1)]))
    assert len(steps) == 5
    assert [s[0].tolist() for s in steps[:4]] == [[10, 3, 7], [11, 4, 7], [12, 5, 7],
                                                 [13, 5, 7]]
    assert [s[1].tolist() for s in steps[:4]] == [[True, True, False]] * 2 + \
        [[True, False, False]] * 2
    assert steps[4][1].tolist() == [False, False, True]
    a = spec.cell("granite-moe-3b.chat").config["repro_arch"]
    f0, f1 = flops.token_flops(a, 0), flops.token_flops(a, 1)
    want = sum(f0 + (f1 - f0) * (p + 1) for p in [10, 3, 11, 4, 12, 13, 7])
    assert harness.model_flops([("block", pos, active, budget, 4),
                                ("step", pos, np.array([False, False, True]), None, 1)],
                               a) == pytest.approx(want)


def test_token_flops_of_granite():
    a = spec.cell("granite-moe-3b.chat").config["repro_arch"]
    d, L = 1536, 32
    per_layer = 2 * d * (2 * 1536 + 2 * 512) + 2 * d * 40 + 8 * 2 * d * 512 * 3
    assert flops.token_flops(a, 0) == pytest.approx(2 * d * 49155 + L * per_layer)
    assert flops.token_flops(a, 100) - flops.token_flops(a, 0) == \
        pytest.approx(L * 4 * 100 * 24 * 64)
    assert flops.attention_layers(a) == [(8, 3, 64)] * 32


def test_token_flops_of_zamba2_count_the_shared_block_at_each_insertion():
    a = spec.cell("zamba2-7b.decode").config["repro_arch"]
    assert flops.attention_layers(a) == [(32, 1, 224)] * 13
    assert flops.token_flops(a, 10) - flops.token_flops(a, 0) == \
        pytest.approx(13 * 4 * 10 * 32 * 224)


def test_the_kernel_bound_is_the_programs():
    """The frozen copy agrees with ``launch/roofline.kernel_bound`` today."""
    from repro_torch.launch import roofline

    for B, KV, G, D, T in [(8, 8, 2, 64, 2048), (8, 32, 1, 224, 2048),
                           (8, 8, 12, 192, 2048), (32, 8, 3, 64, 4160)]:
        want = roofline.kernel_bound(
            "flash_decode", dict(B=B, KV=KV, G=G, D=D, T=T, dtype="bfloat16",
                                 sum_lengths=B * T // 3),
            card_name="NVIDIA H100 80GB HBM3").bound_s
        got = peaks.flash_decode_bound_s(B, KV, G, D, B * T // 3, "bfloat16",
                                         peaks.card("NVIDIA H100 80GB HBM3"))
        assert got == pytest.approx(want)
    # PERF.md's qwen3 row: 10.03 us at (8, 8, 2, 64, 2048)
    assert peaks.flash_decode_bound_s(8, 8, 2, 64, 8 * 2048, "bfloat16",
                                      peaks.card("NVIDIA H100 80GB HBM3")) == \
        pytest.approx(10.03e-6, rel=1e-3)
    with pytest.raises(ValueError):
        peaks.card("NVIDIA A100-SXM4-80GB")


def test_the_sample_holds_the_longest_and_keeps_to_its_caps():
    recs = []
    for i, (p, o) in enumerate([(10, 5), (4, 400), (30, 30), (8, 8), (12, 90)]):
        r = harness.Rec(_offer(i, 0.0, n_prompt=p, n_out=o))
        r.tokens = list(range(o))
        recs.append(r)
    for seed in (1, 2**31 + 3):
        s = harness.sample(recs, seed)
        assert s[0] is recs[1] and len(s) == 5 and s == harness.sample(recs, seed)
    assert len(harness.sample(recs, 5, n=2)) == 2
    capped = harness.sample(recs, 5, max_tokens=430)
    assert capped[0] is recs[1] and sum(len(r.tokens) for r in capped) <= 430
    assert harness.sample([], 5) == []


# five spans of 100 ns, the third a wait; a call of 2 waves in each other
# span, 3 flash_decode launches a wave
_SPANS = [("step_block", 0, 100), ("step_block", 100, 200),
          ("waiting for a request", 200, 300), ("step_block", 300, 400),
          ("step_block", 400, 500)]
_AT = [10, 110, 310, 410]
_WAVES = [2, 2, 2, 2]


def _launches(spans):
    return sorted(a + 20 + k for _, a, _ in spans for k in range(6))


@pytest.mark.parametrize("kept,want", [
    ([0, 1, 3, 4], (0, 500)),  # the whole slice
    ([0, 1], (0, 200)),  # the records of the end lost
    ([3, 4], (200, 500)),  # of the start
    ([0, 3, 4], (200, 500)),  # of the second span: the stretch of more waves
    ([], None),  # only the wait, which holds no wave
])
def test_the_trace_is_read_where_it_holds_every_launch(kept, want):
    fd = _launches([_SPANS[i] for i in kept])
    assert harness.covered(_SPANS, _AT, _WAVES, fd, 3) == want


def test_a_launch_put_into_the_next_span_keeps_the_stretch():
    fd = _launches(_SPANS[:2] + _SPANS[3:])
    shifted = sorted(t + 85 if 100 <= t < 200 else t for t in fd)  # into the wait
    assert harness.covered(_SPANS, _AT, _WAVES, shifted, 3) == (0, 500)


def test_a_span_with_a_launch_too_many_or_too_few_breaks_the_stretch():
    fd = _launches(_SPANS[:2] + _SPANS[3:])
    assert harness.covered(_SPANS, _AT, _WAVES, fd[1:], 3) == (100, 500)
    assert harness.covered(_SPANS, _AT, _WAVES, sorted(fd + [450]), 3) == (0, 400)
    assert harness.covered([_SPANS[0]], _AT[:1], _WAVES[:1], [], 3) is None
