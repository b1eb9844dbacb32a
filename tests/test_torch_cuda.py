"""Checks of the port that need the card.

They skip without a CUDA device, and they import nothing of JAX, so they
run on a machine that has PyTorch and the CUDA toolkit only:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The CUDA ``flash_decode`` is held against its plain PyTorch version on
the cases of ``tests/test_torch_kernels.py`` (which hold the plain
version against the JAX oracle on the CPU), and the served engine is
held against the same engine with the plain attention. The CUDA
``ssd_chunk`` is held against its plain version on the cases of
``tests/test_torch_ssd.py``, and Mamba2 prefill through the kernel
against prefill through the plain version. The engine's captured steps
are held against the eager decode step, its blocks against its host
loop, and ``flash_decode`` inside captured graphs against its plain
version.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core.unified import plan_state, state_records_from_cache  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.kernels.ref import flash_decode_ref, ssd_chunk_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.api import DecoderModel  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.analysis import counters, decode_lint  # noqa: E402
from repro_torch.runtime import graphs  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402
from repro_torch.runtime.residency import StateResidency  # noqa: E402

CASES = [
    (2, 2, 2, 64, 256),
    (1, 1, 4, 128, 300),
    (3, 4, 1, 64, 128),
    (2, 1, 8, 64, 1024),
]
# (atol, rtol) against the plain version in fp32 on the same inputs. fp32:
# the kernel sums in another order than the plain einsum; bf16: one
# rounding of the output to bf16 (at most 2**-8 of it)
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-3, 1e-2)}
# queries at 8x the cache's spread: scores of std 2, a peaked softmax, and
# outputs large enough that a lost share of the positions shows
Q_STD = 4.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _rand(rng, shape, dtype, device, std=0.5):
    x = torch.from_numpy(rng.standard_normal(shape, np.float32) * std)
    return x.to(device=device, dtype=getattr(torch, dtype))


def _check(q, k, v, lengths, dtype):
    before = fd.LAUNCHES
    got = fd.flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    assert fd.LAUNCHES == before + 1
    want = flash_decode_ref(q.float(), k.float(), v.float(), lengths)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,G,D,T", CASES)
def test_flash_decode_kernel_matches_plain(cuda, B, KV, G, D, T, dtype):
    rng = np.random.default_rng(4)
    q = _rand(rng, (B, KV, G, D), dtype, cuda, Q_STD)
    k, v = (_rand(rng, (B, T, KV, D), dtype, cuda) for _ in range(2))
    lengths = torch.from_numpy(rng.integers(1, T + 1, size=B).astype(np.int32))
    _check(q, k, v, lengths.to(cuda), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_on_a_residency_view(cuda, dtype):
    """Length-1 and full rows over a cache that is a view into the state
    buffer, whose batch stride is the plan's slot stride."""
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), n_periods=2, dtype=dtype)
    n_slots, T = 3, 40
    template = init_cache(cfg, n_slots, T, "meta")
    plan = plan_state(state_records_from_cache(template, n_slots=n_slots),
                      n_slots=n_slots, max_len=T)
    res = StateResidency(plan, template, n_slots=n_slots)
    buf = res.init_buffer(cuda)
    buf.view(getattr(torch, dtype)).normal_(0.0, 0.5)
    caches = res.views(buf)
    k, v = caches["period"][0]["attn"][0][1], caches["period"][0]["attn"][1][1]
    assert k.stride(0) > T * k.shape[2] * k.shape[3]
    rng = np.random.default_rng(5)
    q = _rand(rng, (n_slots, k.shape[2], cfg.n_heads // cfg.n_kv_heads, k.shape[3]),
              dtype, cuda, Q_STD)
    lengths = torch.tensor([1, 17, T], dtype=torch.int32, device=cuda)
    _check(q, k, v, lengths, dtype)


# (B, KV, G, D, T, lengths): T split over S > 1 spans, with rows whose later
# spans are all empty (length 1, or inside the first span) and rows that end
# one position into a span
SPLIT_CASES = [
    (2, 1, 8, 64, 1024, [1, 1024]),  # S = 8
    (2, 2, 2, 64, 256, [1, 129]),  # S = 2, the second row one into span 2
    (1, 1, 4, 128, 300, [150]),  # S = 2, a ragged last span
    (8, 8, 2, 64, 2048, [33, 42, 51, 60, 69, 78, 87, 96]),  # the serve mix
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(SPLIT_CASES)))
def test_flash_decode_kernel_merges_spans_with_empty_ones(cuda, case, dtype):
    B, KV, G, D, T, rows = SPLIT_CASES[case]
    assert fd.num_splits(B, KV, T) > 1
    rng = np.random.default_rng(11)
    q = _rand(rng, (B, KV, G, D), dtype, cuda, Q_STD)
    k, v = (_rand(rng, (B, T, KV, D), dtype, cuda) for _ in range(2))
    lengths = torch.tensor(rows, dtype=torch.int32, device=cuda)
    _check(q, k, v, lengths, dtype)


# the pairs built beyond the powers of two at D = 64 and 128: gemma3-4b's
# global layers (320, 2) and gemma3-27b's (168, 2) among them
NEW_PAIRS = sorted({(D, G) for D, G in fd.PAIRS
                    if not (D in (64, 128) and G in (1, 2, 4, 8))})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,G", NEW_PAIRS)
def test_flash_decode_kernel_at_every_new_pair(cuda, D, G, dtype):
    """A warp reads one position (D·itemsize/16 chunks do not divide 32):
    8 spans of 128, a length-1 row (seven empty spans), a row ending one
    position into a span and a full row."""
    B, KV, T = 3, 2, 1024
    assert fd.num_splits(B, KV, T) == 8
    rng = np.random.default_rng(12)
    q = _rand(rng, (B, KV, G, D), dtype, cuda, Q_STD)
    k, v = (_rand(rng, (B, T, KV, D), dtype, cuda) for _ in range(2))
    lengths = torch.tensor([1, 385, T], dtype=torch.int32, device=cuda)
    _check(q, k, v, lengths, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma3-4b", "gemma3-27b"])
def test_flash_decode_kernel_on_a_gemma3_residency_view(cuda, arch, dtype):
    """The global layer of one full-width gemma3 period (5 rings and a
    global cache) at 3 slots x 96 positions: the kernel reads the global
    K/V through views whose batch stride is the plan's slot stride."""
    _check_residency_view(cuda, arch, dtype, 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_kernel_on_a_granite_residency_view(cuda, dtype):
    """One full-width granite-moe layer (24/8 heads of 64: G = 3) at 3
    slots x 96 positions, read through views into its state buffer."""
    _check_residency_view(cuda, "granite-moe-3b-a800m", dtype, 0)


def _check_residency_view(cuda, arch, dtype, layer):
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(arch), n_periods=1, remainder=(), dtype=dtype)
    n_slots, T = 3, 96
    template = init_cache(cfg, n_slots, T, "meta")
    plan = plan_state(state_records_from_cache(template, n_slots=n_slots),
                      n_slots=n_slots, max_len=T)
    res = StateResidency(plan, template, n_slots=n_slots)
    buf = res.init_buffer(cuda)
    buf.view(getattr(torch, dtype)).normal_(0.0, 0.5)
    caches = res.views(buf)
    k, v = caches["period"][layer]["attn"][0][0], caches["period"][layer]["attn"][1][0]
    assert k.shape[1] == T and k.stride(0) > T * k.shape[2] * k.shape[3]
    rng = np.random.default_rng(13)
    G = cfg.n_heads // cfg.n_kv_heads
    q = _rand(rng, (n_slots, cfg.n_kv_heads, G, cfg.resolved_head_dim), dtype, cuda,
              Q_STD)
    lengths = torch.tensor([1, 50, T], dtype=torch.int32, device=cuda)
    _check(q, k, v, lengths, dtype)


def test_flash_decode_kernel_gives_zeros_for_a_length0_row(cuda):
    """Every span of a length-0 row is empty: the merge gives 0, not NaN
    (the deliberate departure of ROADMAP §C)."""
    rng = np.random.default_rng(12)
    q = _rand(rng, (2, 1, 8, 64), "float32", cuda, Q_STD)
    k, v = (_rand(rng, (2, 1024, 1, 64), "float32", cuda) for _ in range(2))
    got = fd.flash_decode(q, k, v, torch.tensor([0, 7], dtype=torch.int32, device=cuda))
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    assert bool(torch.isfinite(got).all())


def test_flash_decode_kernel_on_two_streams_at_once(cuda):
    """Launches queued on two streams run at the same time: each stream
    keeps its own counts of finished spans, so no CTA merges before every
    span of its own launch is done, and every call leaves the counts at 0.
    One stream's row fills half of its 64 spans (slow CTAs beside at once
    finished empty ones), the other's holds one position (CTAs that finish
    at once), so with one set of counts the second stream's spans would be
    counted among the first's. Every launch has its own queries, so a
    partial left in reused scratch by an earlier launch would show."""
    B, KV, G, D, T = 1, 1, 8, 64, 32768  # 64 spans of 512 positions
    n = 32
    assert fd.num_splits(B, KV, T) == 64
    rng = np.random.default_rng(13)
    k, v = (_rand(rng, (B, T, KV, D), "float32", cuda) for _ in range(2))
    lengths = [torch.tensor([n_pos], dtype=torch.int32, device=cuda)
               for n_pos in (T // 2, 1)]
    qs = [[_rand(rng, (B, KV, G, D), "float32", cuda, Q_STD) for _ in range(n)]
          for _ in range(2)]
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    outs = [[], []]
    for i, s in enumerate(streams):
        s.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(s):
            # a first call makes each stream's memory and counts, so no
            # cudaMalloc (which waits for the card) drains the queues below
            fd.flash_decode(qs[i][0], k, v, lengths[i])
    torch.cuda.synchronize()
    for s in streams:
        with torch.cuda.stream(s):
            torch.cuda._sleep(50_000_000)  # ~25 ms: both queues fill first
    for j in range(n):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(fd.flash_decode(qs[i][j], k, v, lengths[i]))
    torch.cuda.synchronize()
    atol, rtol = TOL["float32"]
    for i in range(2):
        for q, got in zip(qs[i], outs[i]):
            want = flash_decode_ref(q, k, v, lengths[i])
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=rtol, atol=atol)
    assert not any(bool(c.any()) for c in fd._COUNTERS.values())


def test_a_cuda_tensor_never_reaches_the_plain_version(cuda):
    """A layout the kernel does not take raises on the card; the plain
    version, which would take it, is never used there."""
    rng = np.random.default_rng(6)
    q = _rand(rng, (2, 2, 2, 64), "float32", cuda)
    k, v = (_rand(rng, (2, 32, 2, 64), "float32", cuda) for _ in range(2))
    lengths = torch.full((2,), 32, dtype=torch.int32, device=cuda)
    q_strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    flash_decode_ref(q_strided.cpu(), k.cpu(), v.cpu(), lengths.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        fd.flash_decode(q_strided, k, v, lengths)


def test_served_engine_runs_the_kernel_on_every_layer(cuda):
    """Kernel and plain attention serve the same greedy tokens (fp32), and
    the kernel engine launches the kernel once per layer per decode step:
    each step is a replay of the captured step, which holds one launch
    per layer, and the wrapper launches nothing while serving."""
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), n_periods=2)
    params = DecoderModel(cfg, cuda).init(torch.Generator(cuda).manual_seed(0))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (1, 5, 3)]
    served = {}
    for cores in ("kernel", "plain"):
        eng = InferenceEngine(cfg, params, n_slots=2, max_len=32, device=cuda,
                              cores=cores)
        ptr = eng.state.buf.data_ptr()
        for prompt, new in zip(prompts, (4, 6, 3)):
            eng.submit(prompt, max_new_tokens=new)
        graphs.reset_kernel_launches()
        done = eng.run_until_done(raise_on_exhausted=True)
        launches = graphs.kernel_launches()["flash_decode"]
        assert fd.LAUNCHES == 0
        step = eng.state.graphs["step"]
        assert launches == step.launches["flash_decode"] * step.replays
        assert eng.state.buf.data_ptr() == ptr
        assert eng.memory_report.state_live_bytes == eng.memory_report.state_planned_bytes
        assert eng.memory_report.allocator_step_peak_bytes is not None
        served[cores] = ({r.request_id: r.tokens for r in done}, eng.slot_log,
                             launches, eng.decode_calls)
    tokens, slot_log, launches, steps = served["kernel"]
    assert (tokens, slot_log) == served["plain"][:2]
    assert launches == steps * cfg.n_layers
    assert served["plain"][2] == 0


# ssd_chunk: (B, L, H, P, N), decay, and the SSM groups B/C come from (None:
# one per head; one group reaches the heads at head stride 0, two through
# repeat_interleave, as mamba_prefill hands them over)
SSD_CASES = {
    "kernels_0": ((2, 64, 2, 32, 16), "original", None),
    "kernels_1": ((1, 128, 4, 64, 128), "original", None),
    "kernels_2": ((2, 256, 1, 64, 64), "original", None),
    "ragged_L33": ((2, 33, 3, 64, 128), "original", None),
    "L1": ((3, 1, 2, 8, 4), "original", None),
    "slow_L256": ((1, 256, 4, 64, 128), "slow", None),
    "slow_L200_P8": ((2, 200, 3, 8, 4), "slow", None),
    "one_group_L96": ((1, 96, 4, 32, 16), "slow", 1),
    # zamba2's layout: heads 0-7 read group 0, heads 8-15 group 1
    "two_groups_L96": ((1, 96, 16, 32, 16), "slow", 2),
    # the tensor-core kernel's edges: one row in a 64-row tile at P = 64; a
    # ragged second row tile at P = 32 with N = 40 (padded to 48); N = 13,
    # which its 16-byte copies do not take (loaded element by element)
    "L1_P64": ((2, 1, 3, 64, 128), "slow", None),
    "ragged_L65_P32_N40": ((1, 65, 2, 32, 40), "slow", 1),
    "N13_L130": ((1, 130, 2, 64, 13), "slow", None),
}
# (atol, rtol) of an output against the plain version in fp32 on the same
# inputs: fp32 summation order; a bf16 output adds one rounding (2**-8)
SSD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-5, 1e-5 + 2.0**-8)}


def _ssd_inputs(rng, device, B, L, H, P, N, decay, groups, x_dtype, state_dtype):
    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(device)

    dt = torch.nn.functional.softplus(randn(B, L, H))
    if decay == "slow":
        dA = -torch.from_numpy(rng.uniform(0.001, 0.02, (B, L, H)).astype(np.float32)).to(device)
    else:
        dA = -torch.exp(randn(B, L, H) * 0.3) * dt
    xd, sd = getattr(torch, x_dtype), getattr(torch, state_dtype)
    G = groups or H
    x = (randn(B, L, H, P) * 0.5).to(xd)
    Bm = ssm._heads((randn(B, L, G, N) * 0.5).to(xd), H)
    Cm = ssm._heads((randn(B, L, G, N) * 0.5).to(xd), H)
    state = (randn(B, H, P, N) * 0.5).to(sd)
    return x, dt, dA, Bm, Cm, state


@pytest.mark.parametrize("x_dtype,state_dtype",
                         [("float32", "float32"), ("bfloat16", "float32"),
                          ("bfloat16", "bfloat16"), ("float32", "bfloat16")])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_chunk_kernel_matches_plain(cuda, case, x_dtype, state_dtype):
    shape, decay, groups = SSD_CASES[case]
    x, dt, dA, Bm, Cm, state = _ssd_inputs(np.random.default_rng(8), cuda, *shape,
                                           decay, groups, x_dtype, state_dtype)
    before = sc.LAUNCHES
    got = sc.ssd_chunk(x, dt, dA, Bm, Cm, state)
    torch.cuda.synchronize()
    assert sc.LAUNCHES == before + 1
    want = ssd_chunk_ref(x.float(), dt, dA, Bm.float(), Cm.float(), state.float())
    for g, w in zip(got, want):
        atol, rtol = SSD_TOL[g.dtype]
        np.testing.assert_allclose(g.float().cpu().numpy(), w.cpu().numpy(),
                                   rtol=rtol, atol=atol)
    assert got[0].dtype == x.dtype and got[1].dtype == state.dtype


def test_ssd_chunk_on_the_card_never_reaches_the_plain_version(cuda):
    """A shape the kernel does not build raises on the card (the plain
    version would take it)."""
    x, dt, dA, Bm, Cm, state = _ssd_inputs(np.random.default_rng(9), cuda, 1, 16, 2,
                                           12, 4, "original", None, "float32",
                                           "float32")
    ssd_chunk_ref(x, dt, dA, Bm, Cm, state)
    with pytest.raises(ValueError, match="head dim"):
        sc.ssd_chunk(x, dt, dA, Bm, Cm, state)


def _slow_decay(params) -> None:
    """A = -exp(A_log) in [-0.02, -0.001] on every Mamba2 layer, so the
    state one chunk hands the next is far above the tolerance (at random
    init A is in [-16, -1] and the state forgets within a token or two)."""
    for layer in params["period"]:
        a_log = layer["mamba"]["A_log"]
        a_log.copy_(torch.log(torch.linspace(0.001, 0.02, a_log.shape[-1],
                                             device=a_log.device)))


@pytest.mark.parametrize("decay", ["original", "slow"])
def test_mamba_prefill_runs_the_kernel_once_per_chunk(cuda, decay, monkeypatch):
    """Reduced mamba2, 2 layers, fp32: the kernel SSD core and the plain
    one give the same logits and caches over 3 chunks, and the kernel
    runs once per chunk per layer. With the slow decay the carried state
    is far above the tolerance: dropping it misses by over 100x."""
    cfg = dataclasses.replace(get_reduced("mamba2-2.7b"), n_periods=2)
    kernel = DecoderModel(cfg, cuda)
    plain = DecoderModel(cfg, cuda, cores="plain")
    params = kernel.init(torch.Generator(cuda).manual_seed(0))
    if decay == "slow":
        _slow_decay(params)
    tokens = torch.from_numpy(
        np.random.default_rng(10).integers(0, cfg.vocab, (2, 600))).to(cuda)
    before = sc.LAUNCHES
    got_logits, got_caches = kernel.prefill(params, {"tokens": tokens})
    assert sc.LAUNCHES - before == 3 * cfg.n_layers
    want_logits, want_caches = plain.prefill(params, {"tokens": tokens})
    assert sc.LAUNCHES - before == 3 * cfg.n_layers
    np.testing.assert_allclose(got_logits.cpu().numpy(), want_logits.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(got_caches["period"][0]["mamba"], want_caches["period"][0]["mamba"]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-4, atol=1e-4)
    if decay == "slow":
        want_state = want_caches["period"][0]["mamba"][1]
        assert float(want_state.abs().max()) > 1e-1
        core = ssm.SSD["plain"]
        monkeypatch.setitem(ssm.SSD, "plain", lambda x, dt, dA, Bm, Cm, state: core(
            x, dt, dA, Bm, Cm, torch.zeros_like(state)))
        _, forgot = plain.prefill(params, {"tokens": tokens})
        err = (forgot["period"][0]["mamba"][1] - want_state).abs()
        assert float((err / (1e-4 + 1e-4 * want_state.abs())).max()) > 100


# ------------------------------------------------ captured decode steps


def _qwen(cuda, seed=0):
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), n_periods=2)
    return cfg, DecoderModel(cfg, cuda).init(torch.Generator(cuda).manual_seed(seed))


def _serve(eng, cfg, seed=7, sizes=(1, 5, 3, 4), new=(4, 6, 3, 5)):
    rng = np.random.default_rng(seed)
    for n, m in zip(sizes, new):
        eng.submit(rng.integers(0, cfg.vocab, size=n).astype(np.int32), max_new_tokens=m)
    done = eng.run_until_done(raise_on_exhausted=True)
    return {r.request_id: r.tokens for r in done}


def test_captured_replay_equals_the_eager_step(cuda):
    """The arena-backed step replayed from its CUDA graph against the
    model's eager decode step on its own caches, step by step: logits and
    every cache leaf within 1e-6 (fp32; bit for bit expected)."""
    cfg, params = _qwen(cuda)
    n, T = 3, 32
    eng = InferenceEngine(cfg, params, n_slots=n, max_len=T, device=cuda)
    assert eng.memory_report.capture_calls == 1 and "step" in eng.state.graphs
    eager = eng.model.init_cache(n, T)
    rng = np.random.default_rng(8)
    pos = np.zeros(n, np.int32)
    for mask in ([1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]):
        tok = rng.integers(0, cfg.vocab, size=(n, 1)).astype(np.int32)
        act = np.array(mask, bool)
        got = eng.state.decode(tok, pos, act).clone()
        want, _ = eng.model.decode_step(params, torch.from_numpy(tok).to(cuda), eager,
                                        torch.from_numpy(pos).to(cuda),
                                        torch.from_numpy(act).to(cuda))
        torch.testing.assert_close(got, want.float(), atol=1e-6, rtol=1e-6)
        for g, w in zip(torch.utils._pytree.tree_leaves(eng.caches),
                        torch.utils._pytree.tree_leaves(eager)):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
        pos = pos + act.astype(np.int32)
    assert eng.state.graphs["step"].replays == 4


def test_the_moe_decode_step_captured_equals_eager(cuda):
    """granite-moe-3b-a800m at full width cut to 2 layers, fp32, 4 slots:
    the captured, arena-backed step (flash_decode at (64, 3), the one-hot
    dispatch of 40 experts top-8) against the eager decode step on its
    own caches, with inactive rows: bit for bit, and the graph holds one
    flash_decode launch per layer."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), n_periods=2,
                              dtype="float32")
    params = DecoderModel(cfg, cuda).init(torch.Generator(cuda).manual_seed(0))
    n, T = 4, 64
    eng = InferenceEngine(cfg, params, n_slots=n, max_len=T, device=cuda)
    assert eng.state.graphs["step"].launches["flash_decode"] == 2
    eager = eng.model.init_cache(n, T)
    rng = np.random.default_rng(9)
    pos = np.zeros(n, np.int32)
    for mask in ([1, 1, 1, 1], [1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 1, 1], [1, 1, 0, 1]):
        tok = rng.integers(0, cfg.vocab, size=(n, 1)).astype(np.int32)
        act = np.array(mask, bool)
        got = eng.state.decode(tok, pos, act).clone()
        want, _ = eng.model.decode_step(params, torch.from_numpy(tok).to(cuda), eager,
                                        torch.from_numpy(pos).to(cuda),
                                        torch.from_numpy(act).to(cuda))
        assert torch.equal(got, want.float())
        for g, w in zip(torch.utils._pytree.tree_leaves(eng.caches),
                        torch.utils._pytree.tree_leaves(eager)):
            assert torch.equal(g, w)
        pos = pos + act.astype(np.int32)
    assert eng.state.graphs["step"].replays == 5


@pytest.mark.parametrize("arch,n_periods,per_step", [("zamba2-7b", 1, 1),
                                                     ("internvl2-1b", 2, 2)])
def test_the_hybrid_and_vlm_decode_steps_captured_equal_eager(cuda, arch, n_periods,
                                                             per_step):
    """zamba2-7b (one period: 5 Mamba2 layers and one after the shared
    block, flash_decode at (224, 1), B/C from 2 groups) and internvl2-1b
    (2 layers, (64, 7)) at full width, fp32, 4 slots: the captured,
    arena-backed step against the eager decode step on its own caches,
    with inactive rows, bit for bit; the graph holds one flash_decode
    launch per shared-block insertion or global layer."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(arch), n_periods=n_periods, remainder=(),
                              dtype="float32")
    params = DecoderModel(cfg, cuda).init(torch.Generator(cuda).manual_seed(0))
    n, T = 4, 64
    eng = InferenceEngine(cfg, params, n_slots=n, max_len=T, device=cuda)
    assert eng.state.graphs["step"].launches["flash_decode"] == per_step
    eager = eng.model.init_cache(n, T)
    rng = np.random.default_rng(10)
    pos = np.zeros(n, np.int32)
    for mask in ([1, 1, 1, 1], [1, 0, 1, 1], [0, 1, 1, 0], [1, 1, 1, 1], [1, 1, 0, 1]):
        tok = rng.integers(0, cfg.vocab, size=(n, 1)).astype(np.int32)
        act = np.array(mask, bool)
        got = eng.state.decode(tok, pos, act).clone()
        want, _ = eng.model.decode_step(params, torch.from_numpy(tok).to(cuda), eager,
                                        torch.from_numpy(pos).to(cuda),
                                        torch.from_numpy(act).to(cuda))
        assert torch.equal(got, want.float())
        for g, w in zip(torch.utils._pytree.tree_leaves(eng.caches),
                        torch.utils._pytree.tree_leaves(eager)):
            assert torch.equal(g, w)
        pos = pos + act.astype(np.int32)
    assert eng.state.graphs["step"].replays == 5


def test_block_tokens_equal_the_host_loop_tokens(cuda):
    cfg, params = _qwen(cuda)
    runs = {}
    for bs in (1, 4):
        eng = InferenceEngine(cfg, params, n_slots=2, max_len=32, device=cuda,
                              block_size=bs)
        assert eng.memory_report.capture_calls == (1 if bs == 1 else 2)
        with counters.capture("host_syncs", "capture_calls") as cap:
            tokens = _serve(eng, cfg)
        assert cap.delta("capture_calls") == 0
        if bs > 1:
            assert cap.delta("host_syncs") == eng.n_blocks
            wave = eng.state.graphs["wave"]
            assert wave.replays == eng.decode_calls - eng.state.graphs["step"].replays
        runs[bs] = (tokens, eng.slot_log, eng.state.buf.cpu())
    assert runs[4][0] == runs[1][0] and runs[4][1] == runs[1][1]
    assert torch.equal(runs[4][2], runs[1][2])


def test_no_host_sync_inside_a_block(cuda):
    """The decode lint on the card, sync check included: clean, and a
    planted ``.item()`` (a read that waits for the card) between two
    replays of a block is found."""
    cfg, params = _qwen(cuda)
    eng = InferenceEngine(cfg, params, n_slots=2, max_len=32, device=cuda, block_size=4)
    rng = np.random.default_rng(9)
    for n in (3, 4):
        eng.submit(rng.integers(0, cfg.vocab, size=n).astype(np.int32), max_new_tokens=9)
    assert decode_lint.lint_run(eng, eng.run_until_done) == []
    replay = eng.state._wave

    def syncing_replay():
        out = replay()
        eng.state._w.k.item()
        return out

    eng.state._wave = syncing_replay
    eng.submit(np.arange(3, dtype=np.int32), max_new_tokens=9)
    findings = decode_lint.lint_run(eng, eng.run_until_done)
    assert [f.code for f in findings] == ["host-sync-in-block"]
    assert torch.cuda.get_sync_debug_mode() == 0


def test_two_engines_on_one_device_give_their_own_results(cuda):
    """Two engines, two sets of graphs and pools on one device, stepped in
    turns: each serves what it serves alone."""
    (cfg, pa), (_, pb) = _qwen(cuda, 0), _qwen(cuda, 1)
    alone = {}
    for name, p in (("a", pa), ("b", pb)):
        alone[name] = _serve(InferenceEngine(cfg, p, n_slots=2, max_len=32,
                                             device=cuda, block_size=3), cfg)
    ea = InferenceEngine(cfg, pa, n_slots=2, max_len=32, device=cuda, block_size=3)
    eb = InferenceEngine(cfg, pb, n_slots=2, max_len=32, device=cuda, block_size=3)
    rng = np.random.default_rng(7)
    for n, m in zip((1, 5, 3, 4), (4, 6, 3, 5)):
        prompt = rng.integers(0, cfg.vocab, size=n).astype(np.int32)
        ea.submit(prompt, max_new_tokens=m)
        eb.submit(prompt, max_new_tokens=m)
    got = {"a": {}, "b": {}}
    while ea.unfinished_requests() or eb.unfinished_requests():
        for name, e in (("a", ea), ("b", eb)):
            got[name].update({r.request_id: r.tokens for r in e.step_block()})
    assert got == alone
    assert alone["a"] != alone["b"]


def _attention_graph(q, k, v, lengths, stream):
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        out = fd.flash_decode(q, k, v, lengths)
    return g, out


def test_flash_decode_counts_survive_two_captures(cuda):
    """Two graphs captured on one stream, after warm-up calls on it that
    made the stream's counts outside both graphs' pools: the first with
    64 counts, the second after a larger call replaced them. Once the
    stream's free small blocks are filled with -1 (and again after the
    first graph is freed), the first graph still finds its old counts and
    the second its new ones, and both agree with the plain version."""
    rng = np.random.default_rng(14)
    D, T, G = 64, 1024, 8
    shapes = [(2, 1), (16, 8)]  # (B, KV): 2 and 128 counts per call
    ks = [[_rand(rng, (B, T, KV, D), "float32", cuda) for _ in range(2)]
          for B, KV in shapes]
    lengths = [torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32)).to(cuda)
               for B, _ in shapes]
    qs = [_rand(rng, (B, KV, G, D), "float32", cuda, Q_STD) for B, KV in shapes]
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    pairs = []
    for i in range(2):
        with torch.cuda.stream(stream):
            fd.flash_decode(qs[i], *ks[i], lengths[i])  # the warm-up
        torch.cuda.synchronize()
        pairs.append(_attention_graph(qs[i], *ks[i], lengths[i], stream))
    want = [flash_decode_ref(qs[i], *ks[i], lengths[i]) for i in range(2)]
    atol, rtol = TOL["float32"]

    def replay_and_check(i, g, out):
        # freed blocks are reused by allocations of their size on their
        # stream: fill every such block with -1
        with torch.cuda.stream(stream):
            filler = [torch.full((n,), -1, dtype=torch.int32, device=cuda)
                      for n in (64, 128, 512) for _ in range(2048)]
        torch.cuda.synchronize()
        for _ in range(3):
            g.replay()
        torch.cuda.synchronize()
        del filler
        np.testing.assert_allclose(out.cpu().numpy(), want[i].cpu().numpy(),
                                   rtol=rtol, atol=atol)

    # the first graph's counts were replaced by the second warm-up
    replay_and_check(0, *pairs[0])
    del pairs[0]  # the first graph freed: its pool may be reused
    replay_and_check(1, *pairs[0])


def test_flash_decode_inside_two_captured_graphs_on_the_same_stream(cuda):
    """Two live graphs on one stream, replayed in turns with new queries
    copied into their static inputs: each agrees with the plain version
    every time, and the counts are left at 0."""
    rng = np.random.default_rng(15)
    B, KV, G, D, T = 8, 8, 2, 64, 2048
    k, v = (_rand(rng, (B, T, KV, D), "bfloat16", cuda) for _ in range(2))
    lengths = [torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32)).to(cuda)
               for _ in range(2)]
    qs = [_rand(rng, (B, KV, G, D), "bfloat16", cuda, Q_STD) for _ in range(2)]
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        fd.flash_decode(qs[0], k, v, lengths[0])
    torch.cuda.synchronize()
    pairs = [_attention_graph(qs[i], k, v, lengths[i], stream) for i in range(2)]
    atol, rtol = TOL["bfloat16"]
    for turn in range(4):
        for i, (g, out) in enumerate(pairs):
            qs[i].copy_(_rand(rng, (B, KV, G, D), "bfloat16", cuda, Q_STD))
            g.replay()
            want = flash_decode_ref(qs[i].float(), k.float(), v.float(), lengths[i])
            np.testing.assert_allclose(out.float().cpu().numpy(), want.cpu().numpy(),
                                       rtol=rtol, atol=atol)
    assert not any(bool(c.any()) for c in fd._COUNTERS.values())


# ------------------------------------------------------ the SMEM plans


def _smem_instantiations():
    from repro_torch.kernels import smem_plan as sp

    for dtype in ("float32", "bfloat16"):
        for D, G in sp.FD_PAIRS:
            yield "flash_decode", dict(G=G, D=D, dtype=dtype)
        for state in ("float32", "bfloat16"):
            for P in sp.SSD_HEAD_DIMS:
                for N in (4, 13, 16, 40, 64, 128):
                    yield "ssd_chunk", dict(P=P, N=N, dtype=dtype, state_dtype=state)


@pytest.mark.parametrize("kernel,shape", list(_smem_instantiations()))
def test_smem_plan_against_the_kernels_request(cuda, kernel, shape):
    """The planned shared memory of one CTA fits the device's opt-in limit
    and is no more than the kernel requests at launch: where it is less,
    the gap is the warps' scan totals of ssd_chunk's prefix sum, dead
    after the scan, which the kernel does not reuse (PERF.md)."""
    from repro_torch.kernels import smem_plan as sp

    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    assert limit == sp.SMEM_BYTES
    if kernel == "flash_decode":
        kp = sp.plan_flash_decode_smem(**shape)
        requested = fd.smem_request_bytes(shape["G"], shape["D"],
                                          getattr(torch, shape["dtype"]))
        gap = 0
    else:
        kp = sp.plan_ssd_chunk_smem(**shape)
        requested = sc.smem_request_bytes(shape["P"], shape["N"],
                                          getattr(torch, shape["dtype"]),
                                          getattr(torch, shape["state_dtype"]))
        gap = 8 * (4 if shape["dtype"] == "bfloat16" else 8)  # warps' float64 totals
    assert kp.fits and requested <= limit
    assert kp.plan.total_size == requested - gap
