"""The port's ``InferenceEngine`` against ``repro.runtime.engine``.

Reduced qwen3 in float32, the reference's params bridged through numpy,
two slots and five requests of different prompt lengths and budgets, so
slots are reused: the greedy tokens, the slot log, the host-sync count
and the state size must all be the reference's. The port's state is one
buffer that never moves.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro.runtime import engine as jax_engine_mod  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime import engine as engine_mod  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

ARCH = "qwen3-0.6b"
PROMPT_LENS = (1, 9, 4, 6, 2)
MAX_NEW = (5, 3, 7, 2, 6)


def _serve(engine, mod, prompts):
    for prompt, new in zip(prompts, MAX_NEW):
        engine.submit(prompt, max_new_tokens=new)
    syncs = mod.HOST_SYNCS
    done = engine.run_until_done(raise_on_exhausted=True)
    return {r.request_id: list(r.tokens) for r in done}, mod.HOST_SYNCS - syncs


def test_engine_matches_the_reference_engine():
    jcfg, cfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in PROMPT_LENS]

    jeng = jax_engine_mod.InferenceEngine(jcfg, jparams, n_slots=2, max_len=64)
    want, want_syncs = _serve(jeng, jax_engine_mod, prompts)

    eng = InferenceEngine(cfg, params, n_slots=2, max_len=64, device="cpu")
    ptr = eng.state.buf.data_ptr()
    got, got_syncs = _serve(eng, engine_mod, prompts)

    assert got == want
    assert eng.slot_log == jeng.slot_log
    assert got_syncs == want_syncs == eng.waves
    rep = eng.memory_report
    assert rep.state_live_bytes == rep.state_plan.total_size
    assert rep.state_live_bytes == jeng.memory_report.state_live_bytes
    assert eng.state.buf.data_ptr() == ptr
    assert rep.allocator_step_peak_bytes is None  # measured on the card only
    assert rep.activation_plan.lower_bound <= rep.activation_plan.total_size


def test_engine_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(cfg, {}, n_slots=2, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run(["--requests", "1"])


@pytest.mark.parametrize("kwargs", [{"session": object()}])
def test_later_slices_raise(kwargs):
    """Plan sessions came with ROADMAP A12.1: a session that is not a
    ``PlanSession`` is refused before anything is built."""
    with pytest.raises(TypeError, match="PlanSession"):
        InferenceEngine(get_reduced(ARCH), {}, n_slots=2, max_len=16,
                        device="cpu", **kwargs)


def test_serve_run_on_the_cpu():
    stats = serve.run(["--device", "cpu", "--requests", "3", "--slots", "2",
                       "--max-len", "32", "--prompt-len", "4", "--max-new", "3"])
    assert stats["requests"] == 3 and stats["tokens"] == 9
    assert stats["state_ptr_before"] == stats["state_ptr_after"]
    assert stats["state_live_bytes"] == stats["state_planned_bytes"]
    assert stats["host_syncs"] == stats["waves"]
    assert stats["decode_calls"] == stats["waves"] + 3 * 3
    assert stats["last_logits_finite"]
