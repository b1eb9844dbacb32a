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
version. The CUDA ``ssd_chunk_bwd`` is held against its plain version in
float64 (its tensor-core kernel also against itself, bit for bit), the
op's autograd against autograd of the plain chunk, and a train step
through both SSD kernels against the plain cores;
``run_training`` trains and resumes on the card.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core.unified import plan_state, state_records_from_cache  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.kernels.ref import (flash_decode_ref, ssd_chunk_bwd_ref,  # noqa: E402
                                     ssd_chunk_bwd_tolerance, ssd_chunk_ref)
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
    assert fd.num_splits(B, KV, G, D, T, getattr(torch, dtype)) > 1
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
    assert fd.num_splits(B, KV, G, D, T, getattr(torch, dtype)) == 8
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,KV,G,D,T", CASES + [(8, 8, 12, 192, 2048)])
def test_flash_decode_lse_kernel_matches_plain(cuda, B, KV, G, D, T, dtype):
    """The kernel's log-sum-exp (written by the merging CTA) and output
    against ``flash_decode_lse_ref`` on the same inputs, rows of length 0
    included (output 0, -1e30); (8, 8, 12, 192, 2048) is one rank's span
    of nemotron-4-340b's decode_32k at (data=16, model=16)."""
    from repro_torch.kernels.ref import flash_decode_lse_ref

    rng = np.random.default_rng(13)
    q = _rand(rng, (B, KV, G, D), dtype, cuda, Q_STD)
    k, v = (_rand(rng, (B, T, KV, D), dtype, cuda) for _ in range(2))
    lengths = rng.integers(1, T + 1, size=B).astype(np.int32)
    lengths[0] = 0
    lengths = torch.from_numpy(lengths).to(cuda)
    before = fd.LAUNCHES
    out, lse = fd.flash_decode_lse(q, k, v, lengths)
    torch.cuda.synchronize()
    assert fd.LAUNCHES == before + 1
    want_out, want_lse = flash_decode_lse_ref(q.float(), k.float(), v.float(), lengths)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(), want_out.cpu().numpy(),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_the_tensor_core_pair_reports_itself_on_the_tensor_cores(cuda):
    """The built library launches the kernel the table names for every
    instantiation: bf16 (192, 12) the tensor-core kernel, every other pair
    and every fp32 one the CUDA-core kernel."""
    for D, G in sorted(fd.PAIRS):
        for dtype in (torch.float32, torch.bfloat16):
            assert fd.reported_path(G, D, dtype) == fd.kernel_path(dtype, D, G)
    assert fd.reported_path(12, 192, torch.bfloat16) == "tensor_core"
    assert fd.reported_path(12, 192, torch.float32) == "cuda_core"
    # two CTAs an SM (__launch_bounds__(128, 2), 98,304 B of shared memory)
    assert fd.ctas_per_sm(12, 192, torch.bfloat16) >= 2


def _nemotron_span(cuda, seed):
    """q and a K/V cache at one rank's span of nemotron-4-340b's decode_32k
    on (data=16, model=16), bf16, with rows ending at a tile edge (64), one
    past it, at a span edge (256), one past it, and T."""
    B, KV, G, D, T = 8, 8, 12, 192, 2048
    rng = np.random.default_rng(seed)
    q = _rand(rng, (B, KV, G, D), "bfloat16", cuda, Q_STD)
    k, v = (_rand(rng, (B, T, KV, D), "bfloat16", cuda) for _ in range(2))
    rows = (1, 64, 65, 256, 257, 1500, 2047, T)
    return rng, q, k, v, rows


def test_the_tensor_core_kernel_gives_the_same_bits_twice(cuda):
    """Two calls at nemotron's span give the same output and log-sum-exp
    bit for bit: every sum runs in a fixed order (the warps' and the
    spans' merges included), whichever CTA merges."""
    _, q, k, v, rows = _nemotron_span(cuda, 18)
    lengths = torch.tensor(rows, dtype=torch.int32, device=cuda)
    a, lse_a = fd.flash_decode_lse(q, k, v, lengths)
    b, lse_b = fd.flash_decode_lse(q, k, v, lengths)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(lse_a.view(torch.int32), lse_b.view(torch.int32))
    assert torch.equal(a, fd.flash_decode(q, k, v, lengths))


def test_the_paged_tensor_core_kernel_equals_the_symmetric_one(cuda):
    """The paged kernel at nemotron's (192, 12), bf16, its K/V read out of
    a shuffled pool of 64 KiB pages: within the bf16 bar of its plain
    version and bit-equal to ``flash_decode`` on the cache gathered out of
    the pool (one kernel, other addresses)."""
    from repro_torch.kernels.ref import flash_decode_paged_ref

    rng, q, _, _, rows = _nemotron_span(cuda, 19)
    B, KV, G, D = q.shape
    args = _paged_pool(rng, B, KV, D, 2048, "bfloat16", 65536, rows, True, cuda)
    lens = torch.tensor(rows, dtype=torch.int32, device=cuda)
    got = fd.flash_decode_paged(q, *args, lens)
    want = flash_decode_paged_ref(q.float(), args[0].float(), *args[1:], lens)
    atol, rtol = TOL["bfloat16"]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol)
    k, v = _paged_gather(args, KV, D)
    assert torch.equal(got, fd.flash_decode(q, k, v, lens))


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
    assert fd.num_splits(B, KV, G, D, T, torch.float32) == 64
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
    # reduced mamba2-2.7b's chunk as examples/train_lm calls it
    "train_lm_mamba2": ((4, 128, 16, 32, 16), "original", 1),
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
                    yield "ssd_chunk_bwd", dict(P=P, N=N, dtype=dtype, state_dtype=state)


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
    elif kernel == "ssd_chunk_bwd":
        kp = sp.plan_ssd_chunk_bwd_smem(**shape)
        requested = sc.bwd_smem_request_bytes(shape["P"], shape["N"],
                                              getattr(torch, shape["dtype"]),
                                              getattr(torch, shape["state_dtype"]))
        # a plan no larger than the source's Layout
        assert kp.fits and requested <= limit and kp.plan.total_size <= requested
        return
    else:
        kp = sp.plan_ssd_chunk_smem(**shape)
        requested = sc.smem_request_bytes(shape["P"], shape["N"],
                                          getattr(torch, shape["dtype"]),
                                          getattr(torch, shape["state_dtype"]))
        gap = 8 * (4 if shape["dtype"] == "bfloat16" else 8)  # warps' float64 totals
    assert kp.fits and requested <= limit
    assert kp.plan.total_size == requested - gap


# ------------------------------------------------------------ paged state


def _paged_pool(rng, B, KV, D, T, dtype, page_bytes, lengths, shuffled, device):
    """One layer's K and V for B slots in a pool of pages: K 48 bytes into
    the slot region, V 16 bytes past K's end; row b of the table maps the
    pages slot b's first ``lengths[b]`` positions touch (ascending, or in a
    random physical order), 0 (the null page) elsewhere. Returns the op's
    arguments before ``lengths``."""
    dt = getattr(torch, dtype)
    vec = 16 // dt.itemsize
    pe = page_bytes // dt.itemsize
    st, sh = KV * D, D
    k_off = 3 * vec
    v_off = k_off + T * st + vec
    pps = -(-(v_off + T * st) // pe)
    phys = np.arange(1, B * pps + 1)
    if shuffled:
        phys = rng.permutation(phys)
    table = phys.reshape(B, pps).astype(np.int32)
    for b, n in enumerate(lengths):
        need = np.zeros(pps, bool)
        for off in (k_off, v_off):
            need[off // pe:(off + n * st - 1) // pe + 1] = True
        table[b] = np.where(need, table[b], 0)
    buf = _rand(rng, ((B * pps + 1) * pe,), dtype, device)
    buf[:pe] = 0
    return (buf, torch.from_numpy(table).to(device), k_off, v_off, st, sh, T, pe)


def _paged_gather(args, KV, D):
    from repro_torch.kernels.ref import paged_index

    buf, table, k_off, v_off, st, sh, T, pe = args
    return tuple(buf[paged_index(table, off, (st, sh, 1), (T, KV, D), pe)]
                 for off in (k_off, v_off))


@pytest.mark.parametrize("page_bytes", [16384, 1040])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shuffled", [False, True])
def test_flash_decode_paged_kernel_matches_plain_and_flash_decode(
        cuda, shuffled, dtype, page_bytes):
    """The paged kernel against its plain version in fp32 on the same pool
    and table (null pages past the lengths, a length-1 row), and bit for
    bit against ``flash_decode`` on the cache gathered out of the pool."""
    from repro_torch.kernels.ref import flash_decode_paged_ref

    rng = np.random.default_rng(16)
    B, KV, G, D, T = 3, 2, 2, 64, 1024
    lengths = (1, 385, 1024)
    args = _paged_pool(rng, B, KV, D, T, dtype, page_bytes, lengths, shuffled, cuda)
    q = _rand(rng, (B, KV, G, D), dtype, cuda, Q_STD)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = fd.PAGED_LAUNCHES
    got = fd.flash_decode_paged(q, *args, lens)
    assert fd.PAGED_LAUNCHES == before + 1
    want = flash_decode_paged_ref(q.float(), args[0].float(), *args[1:], lens)
    atol, rtol = TOL[dtype]
    np.testing.assert_allclose(got.float().cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol)
    k, v = _paged_gather(args, KV, D)
    assert torch.equal(got, fd.flash_decode(q, k, v, lens))


def test_flash_decode_paged_refuses_a_page_of_no_whole_chunks(cuda):
    rng = np.random.default_rng(17)
    args = _paged_pool(rng, 2, 2, 64, 128, "float32", 1000, (5, 128), False, cuda)
    q = _rand(rng, (2, 2, 2, 64), "float32", cuda)
    lens = torch.tensor((5, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="16 bytes"):
        fd.flash_decode_paged(q, *args, lens)
    cfg, params = _qwen(cuda)
    with pytest.raises(ValueError, match="16-byte"):
        InferenceEngine(cfg, params, n_slots=2, max_len=32, device=cuda, page_size=1000)


def test_a_table_update_between_two_replays_of_one_captured_step(cuda):
    """One captured ``flash_decode_paged`` replayed, the table rewritten in
    place (another shuffle of the same pages, the pool's pages moved with
    it, and one slot's pages unmapped), replayed again: each replay reads
    through the table it finds, equal to the plain version on it."""
    from repro_torch.kernels.ref import flash_decode_paged_ref
    from repro_torch.runtime import graphs

    rng = np.random.default_rng(18)
    B, KV, G, D, T = 4, 2, 2, 64, 512
    lengths = (512, 100, 1, 300)
    args = _paged_pool(rng, B, KV, D, T, "bfloat16", 16384, lengths, True, cuda)
    buf, table = args[0], args[1]
    q = _rand(rng, (B, KV, G, D), "bfloat16", cuda, Q_STD)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    step = graphs.CapturedStep(lambda: fd.flash_decode_paged(q, *args, lens),
                               graphs.GraphPool(cuda), name="paged")
    atol, rtol = TOL["bfloat16"]

    def replay_and_check():
        out = step.replay().clone()
        want = flash_decode_paged_ref(q.float(), buf.float(), *args[1:], lens)
        np.testing.assert_allclose(out.float().cpu().numpy(), want.cpu().numpy(),
                                   rtol=rtol, atol=atol)
        return out

    first = replay_and_check()
    # move every mapped page to another physical page, and the table with it
    old = table.cpu().numpy()
    mapped = np.unique(old[old > 0])
    moved = dict(zip(mapped, rng.permutation(mapped)))
    pe = args[-1]
    pages = buf.view(-1, pe)
    pages[torch.from_numpy(np.array([moved[p] for p in mapped])).to(cuda)] = \
        pages[torch.from_numpy(mapped).to(cuda)].clone()
    new = np.vectorize(lambda p: moved.get(p, 0))(old).astype(np.int32)
    new[3] = 0  # slot 3 unmapped: it reads the null page's zeros
    ptr = table.data_ptr()
    table.copy_(torch.from_numpy(new))
    assert table.data_ptr() == ptr
    second = replay_and_check()
    assert torch.equal(first[:3], second[:3])
    assert not second[3].any()
    assert step.replays == 2 and step.launches["flash_decode_paged"] == 1


def test_paged_reset_transient_stays_within_the_pool(cuda):
    """Admission's slot reset reads the dropped slots' mapped pages from
    the host table and gathers no others: across a reset of every slot
    after a run (each slot still maps its last request's pages), the
    allocator's peak stays within the pool's bytes, under an eighth of
    the logical state, and every page the slots mapped reads zero."""
    cfg, params = _qwen(cuda)
    eng = InferenceEngine(cfg, params, n_slots=4, max_len=256, device=cuda,
                          page_size=4096, page_pool=32)
    _serve(eng, cfg)
    rows = eng.state._table.copy()
    assert rows.any()
    assert 8 * eng.state.allocated_bytes < 4 * eng.memory_report.state_plan.slot_stride
    torch.cuda.synchronize(cuda)
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    eng.state.reset(np.zeros(4, bool))
    torch.cuda.synchronize(cuda)
    assert torch.cuda.max_memory_allocated(cuda) - base <= eng.state.allocated_bytes
    pages = eng.state.buf.view(torch.float32).view(-1, 1024)
    mapped = torch.from_numpy(np.unique(rows[rows > 0]).astype(np.int64)).to(cuda)
    assert (pages[mapped] == 0).all()


def test_paged_engine_on_the_card_equals_the_symmetric_one(cuda):
    """Reduced qwen3 (fp32) served paged (1 KiB pages) and symmetric on the
    card, host loop and blocks: tokens and slot logs equal, every decode
    step a replay holding one flash_decode_paged launch per layer and no
    flash_decode, the caches gathered through the table byte-identical,
    and no page live after the drain."""
    cfg, params = _qwen(cuda)
    for block_size in (1, 4):
        sym = InferenceEngine(cfg, params, n_slots=2, max_len=64, device=cuda,
                              block_size=block_size)
        paged = InferenceEngine(cfg, params, n_slots=2, max_len=64, device=cuda,
                                block_size=block_size, page_size=1024)
        assert _serve(paged, cfg) == _serve(sym, cfg)
        assert paged.slot_log == sym.slot_log
        for name, g in paged.state.graphs.items():
            assert g.launches["flash_decode_paged"] == cfg.n_layers, name
            assert g.launches["flash_decode"] == 0, name
        assert sum(g.replays for g in paged.state.graphs.values()) == paged.decode_calls
        for a, b in zip(torch.utils._pytree.tree_leaves(paged.caches),
                        torch.utils._pytree.tree_leaves(sym.caches)):
            assert torch.equal(a.contiguous().view(torch.uint8),
                               b.contiguous().view(torch.uint8))
        assert paged.state.pages_live == 0


def _windowed_gemma3(window):
    cfg = get_reduced("gemma3-4b")
    return dataclasses.replace(cfg, period=tuple(
        dataclasses.replace(s, window=window) if s.window else s for s in cfg.period))


@pytest.mark.parametrize("arch", ["gemma3-4b", "zamba2-7b"])
def test_paged_families_on_the_card_equal_the_symmetric_ones(cuda, arch):
    """Reduced gemma3 (its window cut to 8, so every ring wraps) and
    reduced zamba2 (a Mamba2 layer and one after the shared block), fp32,
    served paged (1000-byte pages: rows and leaves straddle pages) and
    symmetric on the card, host loop and blocks: tokens and slot logs
    equal, every decode step a replay holding one flash_decode_paged
    launch per attention layer or shared-block insertion and no
    flash_decode, the caches gathered through the table byte-identical,
    and the null page zero."""
    cfg = _windowed_gemma3(8) if arch == "gemma3-4b" else get_reduced(arch)
    params = DecoderModel(cfg, cuda).init(torch.Generator(cuda).manual_seed(0))
    per_step = sum(int(s.mixer == "attn") + int(s.shared_attn) for s in cfg.period)
    for block_size in (1, 4):
        sym = InferenceEngine(cfg, params, n_slots=2, max_len=64, device=cuda,
                              block_size=block_size)
        paged = InferenceEngine(cfg, params, n_slots=2, max_len=64, device=cuda,
                                block_size=block_size, page_size=1008)
        sizes, new = (1, 12, 3, 9), (9, 9, 9, 9)
        assert _serve(paged, cfg, sizes=sizes, new=new) == \
            _serve(sym, cfg, sizes=sizes, new=new)
        assert paged.slot_log == sym.slot_log
        for name, g in paged.state.graphs.items():
            assert g.launches["flash_decode_paged"] == per_step, name
            assert g.launches["flash_decode"] == 0, name
        for a, b in zip(torch.utils._pytree.tree_leaves(paged.caches),
                        torch.utils._pytree.tree_leaves(sym.caches)):
            assert torch.equal(a.contiguous().view(torch.uint8),
                               b.contiguous().view(torch.uint8))
        assert not paged.state.buf[:1008].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,window", [(8, 8), (64, 1024), (1024, 1024)])
def test_flash_decode_on_a_wrapped_ring_equals_the_ring_masked_core(cuda, T, window,
                                                                    dtype):
    """A ring whose every slot is past its wrap: flash_decode at lengths =
    min(pos + 1, T) against the reference's ring-masked plain core
    (``attention.decode_attention``) in fp32 on the same ring."""
    from repro_torch.models import attention

    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(T)
    B, KV, G, D = 3, 2, 2, 64
    k = (torch.randn((B, T, KV, D), generator=g, device=cuda) * 0.5).to(dt)
    v = (torch.randn((B, T, KV, D), generator=g, device=cuda) * 0.5).to(dt)
    q = (torch.randn((B, KV, G, D), generator=g, device=cuda) * Q_STD).to(dt)
    pos = torch.tensor([T - 1, 2 * T + 3, 3 * T + T // 2], dtype=torch.int32, device=cuda)
    lengths = torch.clamp(pos + 1, max=T).to(torch.int32)
    got = fd.flash_decode(q, k, v, lengths).reshape(B, 1, KV * G * D).float()
    want = attention.decode_attention(q.float().reshape(B, 1, KV * G, D), k.float(),
                                      v.float(), pos, window)
    atol, rtol = TOL[dtype]
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def test_put_transient_stays_within_the_pages_it_writes(cuda):
    """``PagedLeaf.put`` of one Mamba2 layer's state (reduced zamba2, 4
    slots, 1000-byte pages): the allocator's peak above what was
    allocated stays within the bytes of the pages the layer's runs
    cover, and the layer gathers back what was put."""
    from repro_torch.core.unified import plan_paged_state
    from repro_torch.runtime.paging import PagedStateResidency

    cfg = get_reduced("zamba2-7b")
    template = init_cache(cfg, 4, 64, "meta")
    plan = plan_paged_state(state_records_from_cache(template, n_slots=4), n_slots=4,
                            max_len=64, page_size=1000)
    res = PagedStateResidency(plan, template, n_slots=4)
    buf = res.init_buffer(cuda)
    table = (torch.randperm(plan.n_pages_pool, device=cuda) + 1).reshape(
        4, plan.pages_per_slot).to(torch.int32)
    leaf = res.bind(buf, table)["period"][1]["mamba"][1][0]
    values = torch.randn((4,) + leaf.shape, device=cuda)
    pages = sum(p1 - p0 for p0, p1, _, _ in leaf._runs())
    torch.cuda.synchronize(cuda)
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    leaf.put(values)
    torch.cuda.synchronize(cuda)
    assert torch.cuda.max_memory_allocated(cuda) - base <= 4 * pages * 1000
    assert torch.equal(leaf.gather(), values)


# ------------------------------------------------------------ plan bundles


@pytest.mark.parametrize("page_size", [None, 65536])
@pytest.mark.parametrize("full", [False, True])
def test_a_bundle_compiled_on_meta_has_the_card_engines_records(cuda, tmp_path, full,
                                                                 page_size):
    """qwen3-0.6b (reduced fp32, and full width bf16 at 2 slots x 256),
    symmetric and paged: the bundle ``launch/compile`` traces on ``meta``
    (without its AOT program) has exactly the usage records and the graph fingerprint of the card
    engine's executor trace, the engine served from it plans nothing, and
    its tokens are the plan-at-construction engine's."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import plan_io
    from repro_torch.core.artifact import graph_fingerprint
    from repro_torch.core.unified import PlanSession
    from repro_torch.launch.compile import compile_and_publish

    cfg = get_config("qwen3-0.6b") if full else get_reduced("qwen3-0.6b")
    n_slots, max_len = 2, 256
    # no AOT program: the engine traces its step, which is what is held
    res = compile_and_publish(cfg, str(tmp_path), n_slots=n_slots, max_len=max_len,
                              page_size=page_size, aot=False)
    params = DecoderModel(cfg, cuda).init(torch.Generator(cuda).manual_seed(0))
    with counters.capture("trace_calls", "plan_calls", "state_plan_calls") as cap:
        got = InferenceEngine(cfg, params, n_slots=n_slots, max_len=max_len,
                              device=cuda, page_size=page_size,
                              session=PlanSession.from_manifest(tmp_path))
    assert got.memory_report.plan_source == "bundle", got.memory_report.bundle_warning
    assert cap.deltas() == {"trace_calls": 1, "plan_calls": 0, "state_plan_calls": 0}
    want = InferenceEngine(cfg, params, n_slots=n_slots, max_len=max_len, device=cuda,
                           page_size=page_size)
    canon = plan_io.canonical_records
    assert canon(res.bundle.plan.records) == canon(want.executor.plan.records) == \
        canon(want.decode_graph.usage_records())
    assert graph_fingerprint(want.decode_graph) == res.bundle.graph_fingerprint
    assert _serve(got, cfg) == _serve(want, cfg)


def test_a_plain_cores_bundle_is_refused_by_a_kernel_engine(cuda, tmp_path):
    """A bundle compiled with ``cores="plain"`` traces another graph: the
    served (kernel) engine refuses it by fingerprint with the warning and
    plans at construction; a plain engine takes it."""
    from repro_torch.core.unified import PlanSession
    from repro_torch.launch.compile import compile_and_publish

    cfg = get_reduced("qwen3-0.6b")
    compile_and_publish(cfg, str(tmp_path), n_slots=2, max_len=64, cores="plain")
    params = DecoderModel(cfg, cuda).init(torch.Generator(cuda).manual_seed(0))
    kernel = InferenceEngine(cfg, params, n_slots=2, max_len=64, device=cuda,
                             session=PlanSession.from_manifest(tmp_path))
    rep = kernel.memory_report
    assert rep.plan_source in ("planned", "cache")
    assert "plan bundle fingerprint mismatch" in rep.bundle_warning
    plain = InferenceEngine(cfg, params, n_slots=2, max_len=64, device=cuda,
                            cores="plain", session=PlanSession.from_manifest(tmp_path))
    assert plain.memory_report.plan_source == "bundle"
    assert _serve(kernel, cfg) == _serve(plain, cfg)


# ------------------------------------------------------- AOT decode programs


def _logits_per_wave(eng, cfg, seed=7):
    """Serve ``_serve``'s requests wave by wave; each wave's host logits."""
    rng = np.random.default_rng(seed)
    for n, m in zip((1, 5, 3, 4), (4, 6, 3, 5)):
        eng.submit(rng.integers(0, cfg.vocab, size=n).astype(np.int32), max_new_tokens=m)
    out = []
    while eng.unfinished_requests():
        eng.step()
        out.append(eng.last_logits.copy())
    return out


@pytest.mark.parametrize("page_size", [None, 65536])
@pytest.mark.parametrize("full", [False, True])
def test_a_program_saved_on_meta_replays_on_the_card(cuda, tmp_path, full, page_size):
    """qwen3-0.6b (reduced fp32, and full width bf16 at 2 slots x 256),
    symmetric and paged: the decode program packed on ``meta`` loads onto
    the card (nothing traced), and its engine captures as many graphs,
    with as many launches of each kernel, as the engine that traces its
    step, and replays logits bit-equal to it, wave by wave."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.unified import PlanSession
    from repro_torch.launch.compile import compile_and_publish

    cfg = get_config("qwen3-0.6b") if full else get_reduced("qwen3-0.6b")
    n_slots, max_len = 2, 256
    compile_and_publish(cfg, str(tmp_path), n_slots=n_slots, max_len=max_len,
                        page_size=page_size)
    params = DecoderModel(cfg, cuda).init(torch.Generator(cuda).manual_seed(0))
    with counters.capture("trace_calls", "plan_calls", "state_plan_calls") as cap:
        got = InferenceEngine(cfg, params, n_slots=n_slots, max_len=max_len,
                              device=cuda, page_size=page_size,
                              session=PlanSession.from_manifest(tmp_path))
    rep = got.memory_report
    assert rep.aot_executables, rep.aot_warning
    assert cap.deltas() == {"trace_calls": 0, "plan_calls": 0, "state_plan_calls": 0}
    want = InferenceEngine(cfg, params, n_slots=n_slots, max_len=max_len, device=cuda,
                           page_size=page_size)
    assert rep.capture_calls == want.memory_report.capture_calls > 0
    assert {k: dict(g.launches) for k, g in got.state.graphs.items()} == \
        {k: dict(g.launches) for k, g in want.state.graphs.items()}
    a, b = _logits_per_wave(got, cfg), _logits_per_wave(want, cfg)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_a_pack_from_another_torch_version_is_refused_on_the_card(cuda, tmp_path):
    """The pack's torch version is not this process's: refused whole with
    one warning, the step traced once, the same tokens."""
    import warnings

    from repro_torch.core.artifact import BundleManifest, save_bundle
    from repro_torch.core.unified import PlanSession
    from repro_torch.launch.compile import compile_and_publish

    cfg = get_reduced("qwen3-0.6b")
    res = compile_and_publish(cfg, str(tmp_path), n_slots=2, max_len=64)
    stale = dataclasses.replace(res.bundle, executables=dataclasses.replace(
        res.bundle.executables, torch_version="0.0.0+stale"))
    f = tmp_path / "stale.json"
    save_bundle(stale, f)
    params = DecoderModel(cfg, cuda).init(torch.Generator(cuda).manual_seed(0))
    with counters.capture("trace_calls") as cap, \
            warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = InferenceEngine(cfg, params, n_slots=2, max_len=64, device=cuda,
                              session=PlanSession.from_bundle(f))
    rep = eng.memory_report
    assert "compiled under torch 0.0.0+stale" in rep.aot_warning
    assert [str(x.message) for x in w if x.category is RuntimeWarning] == [rep.aot_warning]
    assert cap.delta("trace_calls") == 1 and rep.aot_executables == ()
    fresh = InferenceEngine(cfg, params, n_slots=2, max_len=64, device=cuda,
                            session=PlanSession.from_manifest(tmp_path))
    assert fresh.memory_report.aot_executables
    assert BundleManifest(tmp_path).buckets()
    assert _serve(eng, cfg) == _serve(fresh, cfg)


def test_residency_off_serves_the_resident_tokens_on_the_card(cuda):
    """The pytree backend on the card: the model's step eagerly over
    allocator-owned caches, nothing captured, the resident engine's
    tokens, and the caches within 1e-6 of the resident engine's after the
    run (reduced qwen3, fp32; bit for bit expected, as the captured step
    against the eager one)."""
    import torch.utils._pytree as pytree

    cfg, params = _qwen(cuda)
    on = InferenceEngine(cfg, params, n_slots=2, max_len=64, device=cuda)
    off = InferenceEngine(cfg, params, n_slots=2, max_len=64, device=cuda,
                          state_residency=False)
    assert off.memory_report.capture_calls == 0 and off.state.graphs == {}
    assert not off.memory_report.state_residency and off.activation_arena is None
    assert _serve(off, cfg) == _serve(on, cfg)
    for x, y in zip(pytree.tree_leaves(off.caches), pytree.tree_leaves(on.caches),
                    strict=True):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=0)


# ------------------------------------------------------------- training


def _bwd_close(name, got, want, L):
    assert ssd_chunk_bwd_tolerance(name, got, want, L) <= 1, (
        name, float((got.double() - want).abs().max()))


@pytest.mark.parametrize("x_dtype,state_dtype",
                         [("float32", "float32"), ("bfloat16", "float32"),
                          ("bfloat16", "bfloat16"), ("float32", "bfloat16")])
@pytest.mark.parametrize("case", sorted(SSD_CASES))
def test_ssd_chunk_bwd_kernel_matches_plain(cuda, case, x_dtype, state_dtype):
    shape, decay, groups = SSD_CASES[case]
    rng = np.random.default_rng(18)
    x, dt, dA, Bm, Cm, state = _ssd_inputs(rng, cuda, *shape, decay, groups, x_dtype,
                                           state_dtype)
    dy = _rand(rng, x.shape, x_dtype, cuda)
    dns = _rand(rng, state.shape, state_dtype, cuda)
    before = sc.BWD_LAUNCHES
    got = sc.ssd_chunk_bwd(x, dt, dA, Bm, Cm, state, dy, dns)
    torch.cuda.synchronize()
    assert sc.BWD_LAUNCHES == before + 1
    want = ssd_chunk_bwd_ref(*(t.double() for t in (x, dt, dA, Bm, Cm, state, dy, dns)))
    names = ("dx", "ddt", "ddA", "dB", "dC", "dstate")
    for name, g, w, t in zip(names, got, want, (x, dt, dA, Bm, Cm, state)):
        assert g.dtype == t.dtype and g.is_contiguous()
        _bwd_close(name, g, w, shape[1])


@pytest.mark.parametrize("state_dtype", ["bfloat16", "float32"])
def test_ssd_chunk_bwd_tensor_core_kernel_gives_the_same_bits_twice(cuda, state_dtype):
    """The tensor-core backward splits a (b, h) over several CTAs and the
    last to arrive sums their parts in a fixed order: two calls on the same
    inputs give the same bits, at mamba2's chunk shape cut to 8 heads and
    batch 2; two CTAs of the bf16-state instantiation share an SM."""
    rng = np.random.default_rng(22)
    x, dt, dA, Bm, Cm, state = _ssd_inputs(rng, cuda, 2, 256, 8, 64, 128, "slow", 1,
                                           "bfloat16", state_dtype)
    dy = _rand(rng, x.shape, "bfloat16", cuda)
    dns = _rand(rng, state.shape, state_dtype, cuda)
    first = sc.ssd_chunk_bwd(x, dt, dA, Bm, Cm, state, dy, dns)
    second = sc.ssd_chunk_bwd(x, dt, dA, Bm, Cm, state, dy, dns)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                           b.view(torch.int16 if b.element_size() == 2 else torch.int32))
    ctas = sc.bwd_ctas_per_sm(64, 128, torch.bfloat16, getattr(torch, state_dtype))
    assert ctas >= (2 if state_dtype == "bfloat16" else 1)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunk_autograd_on_the_card_matches_the_plain_autograd(cuda, groups):
    """The op's backward (the kernel) over a chain of 3 chunks at the slow
    decay, B and C from one or two groups, against autograd of the plain
    chunk in float64."""
    L, H, P, N = 64, 4, 32, 16
    rng = np.random.default_rng(19)
    x, dt, dA, _, _, state = _ssd_inputs(rng, cuda, 1, 3 * L, H, P, N, "slow", None,
                                         "float32", "float32")
    Bg = _rand(rng, (1, 3 * L, groups, N), "float32", cuda)
    Cg = _rand(rng, (1, 3 * L, groups, N), "float32", cuda)
    dy = _rand(rng, x.shape, "float32", cuda)
    dns = _rand(rng, state.shape, "float32", cuda)

    def grads(core, dtype):
        leaves = [t.to(dtype).requires_grad_() for t in (x, dt, dA, state, Bg, Cg)]
        xx, tt, aa, s, bg, cg = leaves
        Bh, Ch = ssm._heads(bg, H), ssm._heads(cg, H)
        total = 0.0
        for c in range(3):
            sl = slice(c * L, (c + 1) * L)
            y, s = core(xx[:, sl], tt[:, sl], aa[:, sl], Bh[:, sl], Ch[:, sl], s)
            total = total + (y * dy[:, sl].to(dtype)).sum()
        return torch.autograd.grad(total + (s * dns.to(dtype)).sum(), leaves)

    before = sc.BWD_LAUNCHES
    got = grads(sc.ssd_chunk, torch.float32)
    assert sc.BWD_LAUNCHES == before + 3
    want = grads(ssd_chunk_ref, torch.float64)
    for name, g, w in zip(("dx", "ddt", "ddA", "dstate", "dB", "dC"), got, want):
        _bwd_close(name, g, w, L)


def test_ssd_chunk_bwd_on_the_card_never_reaches_the_plain_version(cuda):
    """float64, which the plain version takes, raises on the card."""
    x, dt, dA, Bm, Cm, state = _ssd_inputs(np.random.default_rng(20), cuda, 1, 16, 2,
                                           8, 4, "original", None, "float32", "float32")
    args = [t.double() for t in (x, dt, dA, Bm, Cm, state, x, state)]
    ssd_chunk_bwd_ref(*args)
    with pytest.raises(ValueError):
        sc.ssd_chunk_bwd(*args)


def test_a_train_step_on_the_card_goes_through_both_ssd_kernels(cuda):
    """Reduced mamba2 (fp32) at 300 tokens, 2 chunks: one forward and one
    backward launch per layer and chunk, and every gradient leaf within
    1e-3 of its largest entry of the plain cores' (the summation order of
    ``ssd_chunk_bwd_tolerance``, through a layer)."""
    from repro_torch.launch.train import make_loss_fn, value_and_grad
    from repro_torch.tree_util import leaves

    cfg = get_reduced("mamba2-2.7b")
    kernel, plain = DecoderModel(cfg, cuda), DecoderModel(cfg, cuda, cores="plain")
    params = kernel.init(torch.Generator(device=cuda).manual_seed(0))
    _slow_decay(params)
    rng = np.random.default_rng(21)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 301)).astype(np.int32)).to(cuda)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    graphs.reset_kernel_launches()
    loss, _, got = value_and_grad(make_loss_fn(kernel, remat=False), params, batch)
    counts = graphs.kernel_launches()
    assert counts["ssd_chunk"] == counts["ssd_chunk_bwd"] == cfg.n_layers * 2
    want_loss, _, want = value_and_grad(make_loss_fn(plain, remat=False), params, batch)
    assert abs(float(loss) - float(want_loss)) < 1e-5
    for g, w in zip(leaves(got), leaves(want)):
        assert float((g - w).abs().max()) <= 1e-3 * max(float(w.abs().max()), 1e-12)


def test_run_training_trains_and_resumes_on_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.train import run_training
    from repro_torch.tree_util import leaves

    kw = dict(seq_len=32, batch=2, device=cuda)
    full = run_training("qwen3-0.6b", steps=8, **kw)
    assert full[-1]["loss"] < full[0]["loss"]
    path = str(tmp_path / "ck")
    saved = {}
    run_training("qwen3-0.6b", steps=4, ckpt_path=path, save_every=4, out=saved, **kw)
    like = (saved["params"], saved["opt_state"])
    restored, meta = ckpt.restore(path, like)
    assert meta == {"step": 4}
    assert all(torch.equal(a, b) for a, b in zip(leaves(restored), leaves(like)))
    resumed = run_training("qwen3-0.6b", steps=8, ckpt_path=path, **kw)
    assert [abs(a["loss"] - b["loss"]) < 1e-4 for a, b in zip(full[4:], resumed)] == [True] * 4

