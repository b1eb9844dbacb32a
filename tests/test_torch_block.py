"""Block decode in the port, against its own host loop and the reference.

Twin of ``tests/test_block_decode.py``. The single-wave host loop is the
oracle: greedy block decode must serve the same tokens per request, the
same slot log (admission and finish waves) and leave every byte of the
state buffer as the host loop leaves it. It must also give the JAX
block engine's tokens, slot log and host-sync count at the same block
size (reduced configs in float32, the reference's params bridged through
numpy). On-device sampling must be reproducible under a fixed seed and
invariant to the block size; host-loop sampling draws with numpy exactly
as the reference's host loop does.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.analysis import counters as jax_counters  # noqa: E402
from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro.runtime.engine import InferenceEngine as JaxEngine  # noqa: E402
from repro_torch.analysis import counters  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.api import DecoderModel  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

ARCHS = ["qwen3-0.6b", "mamba2-2.7b"]


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
    jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _prompts(cfg, sizes=(4, 6, 3, 5, 4)):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in sizes]


def _run(cfg, params, prompts, *, max_new=6, n_slots=2, max_len=64, **kw):
    engine = InferenceEngine(cfg, params, n_slots=n_slots, max_len=max_len,
                             device="cpu", **kw)
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new)
    with counters.capture("host_syncs") as cap:
        done = engine.run_until_done()
    return engine, {r.request_id: list(r.tokens) for r in done}, cap.delta("host_syncs")


def _run_jax(cfg, params, prompts, *, max_new=6, n_slots=2, max_len=64, **kw):
    engine = JaxEngine(cfg, params, n_slots=n_slots, max_len=max_len, **kw)
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new)
    with jax_counters.capture("host_syncs") as cap:
        done = engine.run_until_done()
    return engine, {r.request_id: list(r.tokens) for r in done}, cap.delta("host_syncs")


@pytest.fixture(scope="module")
def host_loop(setup):
    _, cfg, _, params = setup
    return _run(cfg, params, _prompts(cfg))


@pytest.mark.parametrize("block_size", [2, 3, 4])
def test_greedy_blocks_equal_the_host_loop(setup, host_loop, block_size):
    _, cfg, _, params = setup
    host, host_tokens, host_syncs = host_loop
    block, tokens, syncs = _run(cfg, params, _prompts(cfg), block_size=block_size)
    assert tokens == host_tokens
    assert block.slot_log == host.slot_log
    assert block.waves == host.waves
    assert bytes(block.state.buf.numpy()) == bytes(host.state.buf.numpy())
    assert syncs == block.n_blocks < host_syncs == host.waves
    assert block.decode_calls == host.decode_calls


@pytest.mark.parametrize("block_size", [2, 3, 4])
def test_greedy_blocks_equal_the_reference_blocks(setup, block_size):
    jcfg, cfg, jparams, params = setup
    prompts = _prompts(cfg)
    jeng, jtokens, jsyncs = _run_jax(jcfg, jparams, prompts, block_size=block_size)
    eng, tokens, syncs = _run(cfg, params, prompts, block_size=block_size)
    assert tokens == jtokens
    assert eng.slot_log == [tuple(x) for x in jeng.slot_log]
    assert syncs == jsyncs == eng.n_blocks == jeng.n_blocks


def test_seeded_device_sampling_is_reproducible_and_block_invariant(setup):
    _, cfg, _, params = setup
    prompts = _prompts(cfg, sizes=(4, 5, 3))
    kw = dict(greedy=False, temperature=0.9, top_k=20, max_new=8)
    _, a, _ = _run(cfg, params, prompts, block_size=4, sample_seed=7, **kw)
    _, b, _ = _run(cfg, params, prompts, block_size=4, sample_seed=7, **kw)
    assert a == b, "the same seed must reproduce the sampled trajectory"
    # keys advance per EMISSION, not per wave
    for bs in (2, 3):
        _, c, _ = _run(cfg, params, prompts, block_size=bs, sample_seed=7, **kw)
        assert a == c, f"block_size={bs} changed the sampled tokens"
    _, d, _ = _run(cfg, params, prompts, block_size=4, sample_seed=8, **kw)
    assert a != d, "a different seed must change the trajectory"


def test_eos_stops_on_the_device_as_the_host_oracle(setup):
    _, cfg, _, params = setup
    prompts = _prompts(cfg, sizes=(4,))
    _, ref, _ = _run(cfg, params, prompts, max_new=10)
    ref_tokens = ref[0]
    eos = ref_tokens[2]
    expect = ref_tokens[: ref_tokens.index(eos) + 1]
    for bs in (1, 8):
        _, got, _ = _run(cfg, params, prompts, max_new=10, eos_id=int(eos),
                         block_size=bs)
        assert got[0] == expect, f"block_size={bs}"


def test_block_mode_warns_when_the_wave_budget_runs_out():
    cfg = get_reduced("qwen3-0.6b")
    params = DecoderModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    engine = InferenceEngine(cfg, params, n_slots=1, max_len=64, device="cpu",
                             block_size=4)
    p = _prompts(cfg, sizes=(4,))[0]
    engine.submit(p, max_new_tokens=10)
    engine.submit(p, max_new_tokens=10)
    with pytest.warns(RuntimeWarning, match="exhausted"):
        engine.run_until_done(max_waves=6)
    assert engine.waves <= 6, "block mode must respect the wave budget"
    assert len(engine.unfinished_requests()) >= 1


def test_host_loop_sampling_equals_the_reference(setup):
    """``greedy=False`` in the host loop draws with numpy from the
    fetched logits, as the reference does; the two models' logits agree
    within 1e-4, so the same seed gives the same tokens here."""
    jcfg, cfg, jparams, params = setup
    prompts = _prompts(cfg, sizes=(4, 5, 3))
    kw = dict(greedy=False, sample_seed=3, temperature=0.8, top_k=0, max_new=6)
    _, want, _ = _run_jax(jcfg, jparams, prompts, **kw)
    _, got, _ = _run(cfg, params, prompts, **kw)
    assert got == want


def test_serve_run_in_blocks_with_sampling_on_the_cpu():
    base = ["--device", "cpu", "--requests", "3", "--slots", "2", "--max-len", "32",
            "--prompt-len", "4", "--max-new", "5"]
    host = serve.run(base)
    blocks = serve.run(base + ["--block-size", "4"])
    assert blocks["tokens_per_request"] == host["tokens_per_request"]
    assert blocks["host_syncs"] == blocks["blocks"] < host["host_syncs"]
    assert blocks["capture_calls"] == 0 and blocks["capture_calls_while_serving"] == 0
    assert blocks["executor_in_place"] > 0 and blocks["executor_copied"] > 0
    sampled = serve.run(base + ["--block-size", "4", "--sample", "--temperature", "0.7",
                                "--top-k", "5"])
    again = serve.run(base + ["--block-size", "2", "--sample", "--temperature", "0.7",
                              "--top-k", "5"])
    assert sampled["tokens_per_request"] == again["tokens_per_request"]
    assert sampled["tokens"] == 15
