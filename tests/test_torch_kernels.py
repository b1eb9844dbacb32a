"""The port's ``flash_decode`` against the JAX package's oracle.

On the CPU the port's op runs its plain version (``kernels/ref.py``);
these tests hold that plain version — directly and through the
``repro_torch::flash_decode`` op — against ``repro.kernels.ref``, on the
cases of ``tests/test_kernels.py`` plus a cache that is a strided view
into a state buffer. The CUDA kernel itself runs only on the card: its
cases are in ``tests/test_torch_cuda.py`` (no JAX) and
in ``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import flash_decode_ref as jax_flash_decode_ref  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core.unified import plan_state, state_records_from_cache  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels.ref import flash_decode_lse_ref, flash_decode_ref  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.runtime.residency import StateResidency  # noqa: E402

CASES = [
    (2, 2, 2, 64, 256),
    (1, 1, 4, 128, 300),  # T not a multiple of a tile
    (3, 4, 1, 64, 128),  # MHA (G=1)
    (2, 1, 8, 64, 1024),  # MQA-ish, long cache
]
TOL = {"float32": 2e-6, "bfloat16": 2e-2}


def _as_dtype(x: np.ndarray, dtype: str) -> np.ndarray:
    """numpy float32 -> the dtype's numpy array (bfloat16 via jnp, so
    both frameworks get identical bits)."""
    return np.asarray(jnp.asarray(x).astype(dtype))


def _mk(seed, B, KV, G, D, T, dtype):
    rng = np.random.default_rng(seed)
    q = _as_dtype(rng.standard_normal((B, KV, G, D), np.float32) * 0.5, dtype)
    k = _as_dtype(rng.standard_normal((B, T, KV, D), np.float32) * 0.5, dtype)
    v = _as_dtype(rng.standard_normal((B, T, KV, D), np.float32) * 0.5, dtype)
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    return q, k, v, lengths


def _torch(*arrays):
    return [tensor_from_numpy(a, "cpu") for a in arrays]


def _assert_close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,G,D,T", CASES)
def test_flash_decode_ref_matches_jax_oracle(B, KV, G, D, T, dtype):
    q, k, v, lengths = _mk(0, B, KV, G, D, T, dtype)
    want = jax_flash_decode_ref(q, k, v, lengths)
    tq, tk, tv, tl = _torch(q, k, v, lengths)
    _assert_close(flash_decode_ref(tq, tk, tv, tl), want, TOL[dtype])
    # the custom op on a CPU tensor is the plain version
    _assert_close(fd.flash_decode(tq, tk, tv, tl), want, TOL[dtype])


# gemma3-4b's global heads (D = 320, G = 2) and gemma3-27b's (168, 2)
GEMMA3_CASES = [(2, 4, 2, 320, 300), (2, 2, 2, 168, 300)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,G,D,T", GEMMA3_CASES)
def test_flash_decode_ref_matches_jax_oracle_at_the_gemma3_heads(B, KV, G, D, T, dtype):
    q, k, v, lengths = _mk(3, B, KV, G, D, T, dtype)
    want = jax_flash_decode_ref(q, k, v, lengths)
    tq, tk, tv, tl = _torch(q, k, v, lengths)
    _assert_close(fd.flash_decode(tq, tk, tv, tl), want, TOL[dtype])


def test_flash_decode_short_lengths():
    """Rows with length=1 attend to exactly one position."""
    B, KV, G, D, T = 2, 1, 2, 64, 256
    q, k, v, _ = _mk(1, B, KV, G, D, T, "float32")
    lengths = np.array([1, T], np.int32)
    got = fd.flash_decode(*_torch(q, k, v, lengths))
    np.testing.assert_allclose(
        got[0, 0].numpy(), np.broadcast_to(v[0, 0, 0], (G, D)), rtol=1e-5, atol=1e-5
    )
    _assert_close(got, jax_flash_decode_ref(q, k, v, lengths), TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_on_a_strided_residency_view(dtype):
    """The served cache is a view into the one state buffer: its batch
    stride is the state plan's slot stride, larger than T*KV*D."""
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), n_periods=2, dtype=dtype)
    n_slots, T = 3, 40
    template = init_cache(cfg, n_slots, T, "meta")
    plan = plan_state(state_records_from_cache(template, n_slots=n_slots),
                      n_slots=n_slots, max_len=T)
    res = StateResidency(plan, template, n_slots=n_slots)
    buf = res.init_buffer("cpu")
    flat = buf.view(getattr(torch, dtype))
    rng = np.random.default_rng(2)
    fill = rng.standard_normal(flat.numel(), np.float32) * 0.5
    flat.copy_(tensor_from_numpy(_as_dtype(fill, dtype), "cpu"))
    caches = res.views(buf)
    k, v = caches["period"][0]["attn"][0][1], caches["period"][0]["attn"][1][1]
    KV, D = k.shape[2], k.shape[3]
    assert k.stride(0) == plan.slot_stride // k.element_size() > T * KV * D
    G = cfg.n_heads // cfg.n_kv_heads
    q = _as_dtype(rng.standard_normal((n_slots, KV, G, D), np.float32), dtype)
    lengths = np.array([1, 17, T], np.int32)
    # the oracle reads the same values, copied out contiguous (bf16 -> f32
    # -> bf16 is exact)
    want = jax_flash_decode_ref(
        q, _as_dtype(k.float().numpy(), dtype), _as_dtype(v.float().numpy(), dtype),
        lengths,
    )
    tq, tl = _torch(q, lengths)
    _assert_close(fd.flash_decode(tq, k, v, tl), want, TOL[dtype])


@pytest.mark.parametrize(
    "bad", ["head_dim", "group", "lengths_dtype", "dtype_mix"]
)
def test_flash_decode_refuses_what_the_kernel_does_not_take(bad):
    q, k, v, lengths = _torch(*_mk(3, 2, 2, 2, 64, 32, "float32"))
    if bad == "head_dim":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif bad == "group":  # G = 6 at D = 64: not built
        q = torch.cat([q, q, q], dim=2)
    elif bad == "lengths_dtype":
        lengths = lengths.long()
    else:
        k = k.double()
    with pytest.raises(ValueError):
        fd.flash_decode(q, k, v, lengths)


def _split_and_merge(q, k, v, lengths, n_split):
    """The CUDA kernel's split-T arithmetic in plain PyTorch (fp32): span s
    of ``ceil(T / n_split)`` positions gives the partial (m, l, acc) of an
    online softmax over its live positions, or the sentinel (-1e30, 0, 0)
    when it starts at or past the row's length; the merge weighs each
    partial by exp(m_s - max_s m_s)."""
    B, KV, G, D = q.shape
    T = k.shape[1]
    span = -(-T // n_split)
    scores = torch.einsum("bkgd,btkd->bkgt", q.float() / D ** 0.5, k.float())
    out = torch.empty(B, KV, G, D)
    for b in range(B):
        length = min(max(int(lengths[b]), 0), T)
        m = torch.full((n_split, KV, G), -1e30)
        l = torch.zeros(n_split, KV, G)
        acc = torch.zeros(n_split, KV, G, D)
        for s in range(n_split):
            start, end = s * span, min(s * span + span, length)
            if start >= end:
                continue  # the sentinel partial
            sc = scores[b, :, :, start:end]
            m[s] = sc.amax(-1)
            p = torch.exp(sc - m[s][..., None])
            l[s] = p.sum(-1)
            acc[s] = torch.einsum("kgt,tkd->kgd", p, v[b, start:end].float())
        weight = torch.exp(m - m.amax(0))
        lsum = (l * weight).sum(0)
        out[b] = (acc * weight[..., None]).sum(0) / lsum.clamp_min(1e-30)[..., None]
    return out


@pytest.mark.parametrize("n_split", [1, 2, 8])
@pytest.mark.parametrize("B,KV,G,D,T", CASES)
def test_split_and_merge_equals_the_plain_version(B, KV, G, D, T, n_split):
    """Over S in {1, 2, 8} spans the kernel's split-and-merge arithmetic
    gives the plain version at the fp32 bar, 1e-5 + 1e-5·|want|; the rows
    hold length 1 (every span but the first empty), one position past a
    span boundary, and random lengths."""
    q, k, v, _ = _torch(*_mk(5, B, KV, G, D, T, "float32"))
    q = q * 8.0  # scores of std 2: a peaked softmax, as on the card
    span = -(-T // n_split)
    rows = [1, min(span + 1, T), T] + list(
        np.random.default_rng(6).integers(1, T + 1, size=B))
    lengths = torch.tensor(rows[:B], dtype=torch.int32)
    want = flash_decode_ref(q, k, v, lengths)
    got = _split_and_merge(q, k, v, lengths, n_split)
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())


def test_split_and_merge_of_empty_spans_gives_zeros_not_nan():
    """A length-0 row has only sentinel partials: exp(-1e30 - -1e30) = 1
    weighs l = 0 and acc = 0, so the row is 0 / max(0, 1e-30) = 0 (the
    deliberate departure of ROADMAP §C), never NaN."""
    q, k, v, _ = _torch(*_mk(7, 2, 2, 2, 64, 256, "float32"))
    got = _split_and_merge(q, k, v, torch.tensor([0, 3], dtype=torch.int32), 8)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert torch.isfinite(got).all()


def _lse_numpy(q, k, lengths) -> np.ndarray:
    """Each query head's log-sum-exp of its scaled scores over [0, length),
    in float64."""
    q64, k64 = np.asarray(q, np.float64), np.asarray(k, np.float64)
    s = np.einsum("bkgd,btkd->bkgt", q64 / np.sqrt(q.shape[-1]), k64)
    T = k.shape[1]
    s = np.where(np.arange(T)[None, None, None] < lengths[:, None, None, None], s,
                 -np.inf)
    m = s.max(-1, keepdims=True)
    return (m[..., 0] + np.log(np.exp(s - m).sum(-1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,G,D,T", CASES)
def test_flash_decode_lse_gives_the_output_and_the_log_sum_exp(B, KV, G, D, T, dtype):
    """``flash_decode_lse`` on CPU tensors: the output is the JAX oracle's
    (the bar of ``flash_decode``), and the log-sum-exp the scores' in
    float64 within 1e-5 (the scores are fp32 in both)."""
    q, k, v, lengths = _mk(8, B, KV, G, D, T, dtype)
    want = jax_flash_decode_ref(q, k, v, lengths)
    out, lse = fd.flash_decode_lse(*_torch(q, k, v, lengths))
    _assert_close(out, want, TOL[dtype])
    assert lse.dtype == torch.float32 and lse.shape == (B, KV, G)
    np.testing.assert_allclose(lse.numpy(), _lse_numpy(np.asarray(q, np.float32),
                                                       np.asarray(k, np.float32),
                                                       lengths), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_spans", [2, 4])
@pytest.mark.parametrize("B,KV,G,D,T", CASES)
def test_spans_merged_by_their_lse_are_the_whole_cache(B, KV, G, D, T, n_spans):
    """The context-parallel merge of ``models/attention``: the cache's T cut
    into ``n_spans`` spans (a rank's each), ``flash_decode_lse`` on each
    with its lengths cut to the span (0 past the row's length), and the
    outputs weighed by exp(lse - max lse): the JAX oracle on the whole
    cache, at the fp32 bar. The rows hold length 1, one past the first
    span, and T."""
    q, k, v, _ = _mk(9, B, KV, G, D, T, "float32")
    q = q * 8.0
    Tl = -(-T // n_spans)
    lengths = np.array(([1, min(Tl + 1, T), T] * B)[:B], np.int32)
    want = jax_flash_decode_ref(q, k, v, lengths)
    tq, tk, tv, tl = _torch(q, k, v, lengths)
    outs, lses = [], []
    for r in range(n_spans):
        ks, vs = tk[:, r * Tl:(r + 1) * Tl], tv[:, r * Tl:(r + 1) * Tl]
        n = torch.clamp(tl - r * Tl, 0, ks.shape[1]).to(torch.int32)
        o, lse = fd.flash_decode_lse(tq, ks, vs, n)
        outs.append(o)
        lses.append(lse)
    lse = torch.stack(lses)
    w = torch.exp(lse - lse.amax(0))[..., None]
    got = (torch.stack(outs).float() * w).sum(0) / w.sum(0)
    _assert_close(got, want, TOL["float32"])


def test_flash_decode_lse_of_an_empty_row_is_zero_and_minus_1e30():
    """A span the row has not reached (lengths 0) gives the output 0 and the
    log-sum-exp -1e30, as the kernel's merge writes them: its weight
    beside any real span is exp(-1e30 - m) = 0."""
    q, k, v, _ = _torch(*_mk(10, 2, 2, 2, 64, 128, "float32"))
    out, lse = fd.flash_decode_lse(q, k, v, torch.tensor([0, 5], dtype=torch.int32))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool((lse[0] == -1e30).all()) and bool(torch.isfinite(lse[1]).all())


@pytest.mark.parametrize("B,KV,T,want", [
    (8, 8, 2048, 8),  # the qwen3 serving shape: 8 spans of 256, 512 CTAs
    (3, 4, 128, 1),  # too short to split
    (2, 1, 1024, 8),  # capped at T // MIN_SPAN
    (1, 1, 300, 2),
    (64, 8, 4096, 1),  # 512 CTAs already
])
def test_num_splits_comes_from_the_shapes(B, KV, T, want):
    n = fd.num_splits(B, KV, 2, 64, T, torch.bfloat16)
    assert n == want
    assert n == 1 or B * KV * n >= fd.TARGET_CTAS or n == T // fd.MIN_SPAN
    assert fd.scratch_bytes(B, KV, 2, 64, T, torch.bfloat16) == B * KV * n * 2 * 66 * 4


@pytest.mark.parametrize("B,KV,T,want", [
    (8, 8, 2048, 4),  # nemotron's span: 256 CTAs, one wave at two an SM
    (3, 2, 1024, 8),  # capped at T // MIN_SPAN
    (1, 1, 300, 2),
    (32, 8, 2048, 1),  # 256 CTAs already
    (64, 8, 4096, 1),  # more than a wave: never below one span
])
def test_num_splits_on_the_tensor_cores_fills_one_wave(B, KV, T, want):
    n = fd.num_splits(B, KV, 12, 192, T, torch.bfloat16)
    assert n == want
    assert B * KV * n <= fd.TARGET_CTAS or n == 1
    assert n == T // fd.MIN_SPAN or n == 1 or 2 * B * KV * n > fd.TARGET_CTAS
    assert fd.scratch_bytes(B, KV, 12, 192, T, torch.bfloat16) == B * KV * n * 12 * 194 * 4


def test_the_tensor_core_kernels_scratch_at_nemotrons_span():
    """8 slots x 8 KV heads x 4 spans x G=12 x (192 + 2) fp32: 2,383,872 B;
    fp32 stays on the CUDA-core kernel, whose 8 spans take twice that."""
    assert fd.kernel_path(torch.bfloat16, 192, 12) == "tensor_core"
    assert fd.scratch_bytes(8, 8, 12, 192, 2048, torch.bfloat16) == 2_383_872
    assert fd.kernel_path(torch.float32, 192, 12) == "cuda_core"
    assert fd.scratch_bytes(8, 8, 12, 192, 2048, torch.float32) == 2 * 2_383_872


def test_serving_scratch_is_a_quarter_mib():
    """8 slots x 8 KV heads x 8 spans x G=2 x (64 + 2) fp32: 270,336 B."""
    assert fd.scratch_bytes(8, 8, 2, 64, 2048, torch.bfloat16) == 270_336


def test_counts_are_never_made_while_a_graph_is_captured(monkeypatch):
    """The stream's counts come from a warm-up call, outside any graph's
    pool: asked for under capture, they exist or the call raises."""
    key = (torch.device("cpu"), 987654)
    monkeypatch.setitem(fd._COUNTERS, key, torch.zeros(64, dtype=torch.int32))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert fd._counters(*key, 64) is fd._COUNTERS[key]  # made before: used
    with pytest.raises(RuntimeError, match="before capturing"):
        fd._counters(*key, 65)  # would have to grow
    with pytest.raises(RuntimeError, match="before capturing"):
        fd._counters(torch.device("cpu"), 987655, 8)  # never made
    assert (torch.device("cpu"), 987655) not in fd._COUNTERS


def test_replaced_counts_stay_alive(monkeypatch):
    """A graph captured with a stream's counts reads them at every
    replay, so counts that larger ones replace are kept."""
    key = (torch.device("cpu"), 987656)
    monkeypatch.setattr(fd, "_RETIRED", [])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    small = fd._counters(*key, 8)
    big = fd._counters(*key, 200)
    assert big.numel() == 200 and small.numel() == 64
    assert fd._RETIRED == [small] and fd._COUNTERS.pop(key) is big


def _tensor_core_decode(q, k, v, lengths, n_split, p_bf16=True):
    """The arithmetic of the tensor-core kernel (``flash_decode_tc_kernel``
    of ``csrc/flash_decode.cu``) in plain PyTorch, on bf16 q, K and V: S
    from exact products summed in fp32 (float64, then rounded), the scale
    applied to S in fp32; each span of ``ceil(T / n_split)`` positions cut
    into tiles of 64, 16 positions to each of 4 warps, each warp with its
    own online softmax (m, l, O); P rounded to bf16 before P·V (exact
    products, fp32 sums) while l sums the fp32 p; the warps merged, then
    the spans, as the CUDA-core kernel merges them. Returns the output in
    fp32 before its rounding to bf16 and each query head's log-sum-exp
    (-1e30 for a row of length 0). ``p_bf16=False`` keeps P in fp32."""
    B, KV, G, D = q.shape
    T = k.shape[1]
    warps, rows = 4, 16
    span = -(-T // n_split)
    scale = torch.tensor(1.0 / D ** 0.5, dtype=torch.float32)
    scores = torch.einsum("bkgd,btkd->bkgt", q.double(), k.double()).float() * scale
    out = torch.zeros(B, KV, G, D)
    lse = torch.empty(B, KV, G)
    for b in range(B):
        length = min(max(int(lengths[b]), 0), T)
        pm = torch.full((n_split, KV, G), -1e30)
        pl = torch.zeros(n_split, KV, G)
        pacc = torch.zeros(n_split, KV, G, D)
        for s in range(n_split):
            start, end = s * span, min(s * span + span, length)
            if start >= end:
                continue  # the sentinel partial
            wm = torch.full((warps, KV, G), -1e30)
            wl = torch.zeros(warps, KV, G)
            wo = torch.zeros(warps, KV, G, D)
            for t0 in range(start, end, warps * rows):
                for w in range(warps):
                    p0 = t0 + w * rows
                    if p0 >= end:
                        continue  # none of the warp's rows is live
                    sc = scores[b, :, :, p0:min(p0 + rows, end)]
                    mx = torch.maximum(wm[w], sc.amax(-1))
                    corr = torch.exp(wm[w] - mx)
                    wm[w] = mx
                    p = torch.exp(sc - mx[..., None])
                    wl[w] = wl[w] * corr + p.sum(-1)
                    pp = p.bfloat16() if p_bf16 else p
                    pv = torch.einsum("kgt,tkd->kgd", pp.double(),
                                      v[b, p0:p0 + p.shape[-1]].double())
                    wo[w] = ((wo[w] * corr[..., None]).double() + pv).float()
            mx = wm.amax(0)
            e = torch.exp(wm - mx)
            pm[s], pl[s], pacc[s] = mx, (wl * e).sum(0), (wo * e[..., None]).sum(0)
        mx = pm.amax(0)
        weight = torch.exp(pm - mx)
        lsum = (pl * weight).sum(0)
        out[b] = (pacc * weight[..., None]).sum(0) / lsum.clamp_min(1e-30)[..., None]
        lse[b] = torch.where(lsum > 0, mx + torch.log(lsum.clamp_min(1e-30)),
                             torch.tensor(-1e30))
    return out, lse


# nemotron's (D, G) = (192, 12) at small T: (B, KV, T, lengths) with rows of
# length 0, 1, a tile edge (64), one past it, a span edge and T
TENSOR_CORE_CASES = [
    (6, 2, 512, [0, 1, 64, 128, 129, 512]),  # 4 spans of 128: 2 tiles each
    (4, 1, 200, [0, 63, 65, 200]),  # one span of 200: a ragged last tile
    (2, 1, 1024, [385, 1024]),  # 8 spans of 128
]


@pytest.mark.parametrize("case", range(len(TENSOR_CORE_CASES)))
def test_tensor_core_arithmetic_matches_the_jax_oracle(case):
    """The tensor-core kernel's arithmetic (``_tensor_core_decode``) at
    (192, 12) in bf16, split as the wrapper splits T: the output against
    the JAX oracle on the same values in fp32 at the bf16 bar, 1e-3 +
    1e-2·|want| (the bf16 P and the output's rounding); the log-sum-exp
    against the scores' in float64 and against ``flash_decode_lse_ref`` in
    fp32 within 1e-5 + 1e-5·|want| (the card test's bar); a row of length
    0 gives the output 0 and -1e30."""
    B, KV, T, rows = TENSOR_CORE_CASES[case]
    G, D = 12, 192
    q, k, v, _ = _mk(21 + case, B, KV, G, D, T, "bfloat16")
    q = _as_dtype(np.asarray(q, np.float32) * 8.0, "bfloat16")  # scores of std 2
    lengths = np.array(rows, np.int32)
    tq, tk, tv, tl = _torch(q, k, v, lengths)
    n_split = fd.num_splits(B, KV, G, D, T, torch.bfloat16)
    got, lse = _tensor_core_decode(tq, tk, tv, tl, n_split)
    got = got.bfloat16()
    assert fd.kernel_path(torch.bfloat16, D, G) == "tensor_core"
    live = lengths > 0
    q32, k32, v32 = (np.asarray(a, np.float32) for a in (q, k, v))
    want = np.asarray(jax_flash_decode_ref(q32, k32, v32, lengths), np.float32)
    err = np.abs(got.float().numpy() - want)
    assert (err[live] <= 1e-3 + 1e-2 * np.abs(want[live])).all(), err.max()
    want_lse = _lse_numpy(q32[live], k32[live], lengths[live])
    np.testing.assert_allclose(lse.numpy()[live], want_lse, rtol=1e-5, atol=1e-5)
    ref_out, ref_lse = flash_decode_lse_ref(*(t.float() for t in (tq, tk, tv)), tl)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), rtol=1e-5, atol=1e-5)
    ref_err = (got.float() - ref_out).abs()
    assert bool((ref_err <= 1e-3 + 1e-2 * ref_out.abs()).all())
    assert torch.equal(got[~torch.from_numpy(live)].float(),
                       torch.zeros_like(got[~torch.from_numpy(live)].float()))
    assert bool((lse[~torch.from_numpy(live)] == -1e30).all())


def test_bf16_p_is_what_the_tensor_core_arithmetic_adds():
    """With P kept in fp32 the emulation's output meets the fp32 bar
    against the plain version, 1e-5 + 1e-5·|want|: the bf16 P is the one
    rounding the tensor-core path adds before the output's (held to the
    bf16 bar above), and it moves the output by more than that bar."""
    B, KV, G, D, T = 2, 1, 12, 192, 256
    q, k, v, _ = _torch(*_mk(30, B, KV, G, D, T, "bfloat16"))
    q = q * 8
    lengths = torch.tensor([100, 256], dtype=torch.int32)
    exact = flash_decode_lse_ref(q.float(), k.float(), v.float(), lengths)
    n_split = fd.num_splits(B, KV, G, D, T, torch.bfloat16)
    fp32_p, lse = _tensor_core_decode(q, k, v, lengths, n_split, p_bf16=False)
    bf16_p, _ = _tensor_core_decode(q, k, v, lengths, n_split)
    bar = 1e-5 + 1e-5 * exact[0].abs()
    assert bool(((fp32_p - exact[0]).abs() <= bar).all())
    assert not bool(((bf16_p - exact[0]).abs() <= bar).all())
    assert bool(((lse - exact[1]).abs() <= 1e-5 + 1e-5 * exact[1].abs()).all())


def test_the_kernel_tables_agree():
    """``csrc/flash_decode.cu``'s FD_PAIRS and FD_TC_PAIRS, the wrapper's
    PAIRS and the SMEM plan's FD_PAIRS and FD_TC_PAIRS name the same
    pairs; every tensor-core pair is built, and the wrapper picks the
    tensor-core kernel exactly for the bf16 instantiations of the
    source's FD_TC_PAIRS."""
    import re
    from pathlib import Path

    from repro_torch.kernels import smem_plan as sp

    src = (Path(fd.__file__).parent / "csrc" / "flash_decode.cu").read_text()

    def pairs(macro):
        body = re.search(rf"#define {macro}\(X\)((?:.*\\\n)*.*)", src).group(1)
        return {(int(d), int(g)) for d, g in re.findall(r"X\((\d+), (\d+)\)", body)}

    assert pairs("FD_PAIRS") == set(fd.PAIRS) == set(sp.FD_PAIRS)
    tc = pairs("FD_TC_PAIRS")
    assert tc == set(sp.FD_TC_PAIRS) == {(192, 12)}
    assert tc <= fd.PAIRS
    for D, G in fd.PAIRS:
        assert fd.kernel_path(torch.float32, D, G) == "cuda_core"
        assert fd.kernel_path(torch.bfloat16, D, G) == (
            "tensor_core" if (D, G) in tc else "cuda_core")
