"""Checks of the port that need the card.

They skip without a CUDA device, and they import nothing of JAX, so they
run on a machine that has PyTorch and the CUDA toolkit only:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The CUDA ``flash_decode`` is held against its plain PyTorch version on
the cases of ``tests/test_torch_kernels.py`` (which hold the plain
version against the JAX oracle on the CPU), and the served engine is
held against the same engine with the plain attention.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core.unified import plan_state, state_records_from_cache  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels.ref import flash_decode_ref  # noqa: E402
from repro_torch.models.api import DecoderModel  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
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
    the kernel engine launches the kernel once per layer per decode step."""
    cfg = dataclasses.replace(get_reduced("qwen3-0.6b"), n_periods=2)
    params = DecoderModel(cfg, cuda).init(torch.Generator(cuda).manual_seed(0))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (1, 5, 3)]
    served = {}
    for attention in ("kernel", "plain"):
        eng = InferenceEngine(cfg, params, n_slots=2, max_len=32, device=cuda,
                              attention=attention)
        ptr = eng.state.buf.data_ptr()
        for prompt, new in zip(prompts, (4, 6, 3)):
            eng.submit(prompt, max_new_tokens=new)
        before = fd.LAUNCHES
        done = eng.run_until_done(raise_on_exhausted=True)
        launches = fd.LAUNCHES - before
        assert eng.state.buf.data_ptr() == ptr
        assert eng.memory_report.state_live_bytes == eng.memory_report.state_planned_bytes
        assert eng.memory_report.allocator_step_peak_bytes is not None
        served[attention] = ({r.request_id: r.tokens for r in done}, eng.slot_log,
                             launches, eng.decode_calls)
    tokens, slot_log, launches, steps = served["kernel"]
    assert (tokens, slot_log) == served["plain"][:2]
    assert launches == steps * cfg.n_layers
    assert served["plain"][2] == 0
