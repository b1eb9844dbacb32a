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
from repro_torch.kernels.ref import flash_decode_ref  # noqa: E402
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
    elif bad == "group":
        q = torch.cat([q, q[:, :, :1]], dim=2)
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


@pytest.mark.parametrize("B,KV,T,want", [
    (8, 8, 2048, 8),  # the qwen3 serving shape: 8 spans of 256, 512 CTAs
    (3, 4, 128, 1),  # too short to split
    (2, 1, 1024, 8),  # capped at T // MIN_SPAN
    (1, 1, 300, 2),
    (64, 8, 4096, 1),  # 512 CTAs already
])
def test_num_splits_comes_from_the_shapes(B, KV, T, want):
    n = fd.num_splits(B, KV, T)
    assert n == want
    assert n == 1 or B * KV * n >= fd.TARGET_CTAS or n == T // fd.MIN_SPAN
    assert fd.scratch_bytes(B, KV, 2, 64, T) == B * KV * n * 2 * 66 * 4


def test_serving_scratch_is_a_quarter_mib():
    """8 slots x 8 KV heads x 8 spans x G=2 x (64 + 2) fp32: 270,336 B."""
    assert fd.scratch_bytes(8, 8, 2, 64, 2048) == 270_336


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
