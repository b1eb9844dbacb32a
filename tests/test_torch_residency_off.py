"""The residency-off state backend (``runtime/residency.PytreeState``)
against the resident engine and the JAX engine.

Twin of ``tests/test_residency.py``'s engine cases. Reduced configs in
float32, 2 slots x 48 positions, five requests through two slots
(staggered admissions, slot reuse, resets):

* ``state_residency=False`` serves the same tokens as the resident
  engine and leaves every cache leaf bitwise equal, host loop and blocks
  of 4, for qwen3, mamba2, gemma3 (its window cut to 8, every ring
  wraps), granite-moe, zamba2 and internvl2;
* its tokens equal the JAX engine's with ``state_residency=False``;
* the ``REPRO_STATE_RESIDENCY`` knob and the kwarg's precedence;
* a paged bucket with residency off warns the reference's line and
  serves symmetric state; a bundle serves its plans but not its program;
* the report: no arena, no executor, live bytes the caches', the plans
  those of the resident engine (accounting).
"""

import dataclasses
import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro.runtime import engine as jax_engine_mod  # noqa: E402
from repro_torch.analysis import counters, decode_lint  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core import plan_io  # noqa: E402
from repro_torch.core.artifact import graph_fingerprint  # noqa: E402
from repro_torch.core.unified import PagedStatePlan, PlanSession  # noqa: E402
from repro_torch.launch import compile as compile_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402
from repro_torch.runtime.residency import (PytreeState, ResidentState,  # noqa: E402
                                           residency_enabled)

N_SLOTS, MAX_LEN = 2, 48
# (arch, window cut or None): gemma3's cut window wraps every ring
FAMILIES = [("qwen3-0.6b", None), ("mamba2-2.7b", None), ("gemma3-4b", 8),
            ("granite-moe-3b-a800m", None), ("zamba2-7b", None),
            ("internvl2-1b", None)]


def _windowed(cfg, window):
    if window is None:
        return cfg

    def cut(specs):
        return tuple(dataclasses.replace(s, window=window) if s.window else s
                     for s in specs)
    return dataclasses.replace(cfg, period=cut(cfg.period), remainder=cut(cfg.remainder))


@functools.lru_cache(maxsize=None)
def _params(arch, window=None):
    jcfg = _windowed(jax_get_reduced(arch), window)
    cfg = _windowed(get_reduced(arch), window)
    jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _prompts(cfg, window):
    sizes, new = ((4, 12, 3, 9, 4), 9) if window else ((4, 6, 3, 5, 4), 5)
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in sizes], new


def _serve(engine, arch, window):
    prompts, new = _prompts(_params(arch, window)[2], window)
    for p in prompts:
        engine.submit(p, max_new_tokens=new)
    return {r.request_id: list(r.tokens) for r in engine.run_until_done(
        raise_on_exhausted=True)}


def _engine(arch, window=None, **kw):
    cfg, params = _params(arch, window)[2:]
    return InferenceEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                           device="cpu", **kw)


def _bits(engine):
    return [x.contiguous().view(torch.uint8).numpy().tobytes()
            for x in pytree.tree_leaves(engine.caches)]


# --------------------------------------------------- against the resident engine


@pytest.mark.parametrize("block_size", [1, 4])
@pytest.mark.parametrize("arch,window", FAMILIES)
def test_residency_off_serves_the_same_tokens_and_cache_bits(arch, window, block_size):
    on = _engine(arch, window, block_size=block_size, state_residency=True)
    off = _engine(arch, window, block_size=block_size, state_residency=False)
    assert isinstance(on.state, ResidentState) and on.state.residency
    assert isinstance(off.state, PytreeState) and not off.state.residency
    assert _serve(off, arch, window) == _serve(on, arch, window)
    assert off.waves == on.waves and off.slot_log == on.slot_log
    shapes = [(x.shape, x.dtype) for x in pytree.tree_leaves(on.caches)]
    assert [(x.shape, x.dtype) for x in pytree.tree_leaves(off.caches)] == shapes
    assert _bits(off) == _bits(on)


@pytest.mark.parametrize("arch,window", FAMILIES)
def test_residency_off_tokens_equal_the_jax_engine(arch, window):
    jcfg, jparams = _params(arch, window)[:2]
    jeng = jax_engine_mod.InferenceEngine(jcfg, jparams, n_slots=N_SLOTS,
                                          max_len=MAX_LEN, state_residency=False)
    assert not jeng.memory_report.state_residency
    assert _serve(_engine(arch, window, state_residency=False), arch, window) == \
        _serve(jeng, arch, window)


# ------------------------------------------------------------------- knobs


def test_the_env_knob_and_the_kwargs_precedence(monkeypatch):
    monkeypatch.delenv("REPRO_STATE_RESIDENCY", raising=False)
    assert residency_enabled(None) and not residency_enabled(False)
    for off in ("off", "0", "false", "NO", " no "):
        monkeypatch.setenv("REPRO_STATE_RESIDENCY", off)
        assert not residency_enabled(None)
        assert residency_enabled(True)  # the kwarg wins
    for on in ("on", "1", "yes", ""):
        monkeypatch.setenv("REPRO_STATE_RESIDENCY", on)
        assert residency_enabled(None)
    monkeypatch.setenv("REPRO_STATE_RESIDENCY", "off")
    assert not _engine("qwen3-0.6b").memory_report.state_residency
    assert _engine("qwen3-0.6b", state_residency=True).memory_report.state_residency


def test_a_paged_bucket_with_residency_off_warns_and_serves_symmetric():
    paged = _engine("qwen3-0.6b", page_size=1024)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        off = _engine("qwen3-0.6b", page_size=1024, state_residency=False)
    msgs = [str(x.message) for x in w if x.category is RuntimeWarning]
    assert msgs == ["paged state requires state residency; serving the symmetric "
                    "allocator-owned pytree backend instead"]
    assert not off.paged and isinstance(off.state, PytreeState)
    rep = off.memory_report
    # the state plan is the paged bucket's, kept as accounting
    assert isinstance(rep.state_plan, PagedStatePlan)
    assert rep.state_pages_total is None and rep.state_page_size is None
    assert off.page_log == []
    assert _serve(off, "qwen3-0.6b", None) == _serve(paged, "qwen3-0.6b", None)


# ------------------------------------------------------------------ report


def test_the_report_keeps_the_plans_as_accounting():
    on = _engine("mamba2-2.7b")
    with counters.capture("trace_calls", "plan_calls", "state_plan_calls") as cap:
        off = _engine("mamba2-2.7b", state_residency=False)
    # the program is traced on meta, planned, and its state laid out
    assert cap.deltas() == {"trace_calls": 1, "plan_calls": 1, "state_plan_calls": 1}
    assert off.executor is None and off.activation_arena is None and off.residency is None
    assert off.state.buf is None and off.state.graphs == {}
    assert graph_fingerprint(off.decode_graph) == graph_fingerprint(on.decode_graph)
    rep, ron = off.memory_report, on.memory_report
    assert plan_io.canonical_records(rep.activation_plan.records) == \
        plan_io.canonical_records(ron.activation_plan.records)
    assert rep.activation_plan.total_size == ron.activation_plan.total_size
    assert rep.state_plan == ron.state_plan
    assert rep.state_live_bytes == off.state.live_bytes == sum(
        x.numel() * x.element_size() for x in pytree.tree_leaves(off.caches))
    assert rep.state_live_bytes == ron.state_plan.total_size  # no padding here
    assert rep.executor_in_place == rep.executor_copied == 0
    assert rep.trace_s > 0 and rep.aot_executables == ()
    text = rep.summary()
    assert "state residency: OFF" in text and "not allocated" in text
    assert "state residency: OFF" not in ron.summary()


def test_a_bundle_serves_its_plans_but_not_its_program(tmp_path):
    cfg = _params("qwen3-0.6b")[2]
    compile_mod.compile_and_publish(cfg, str(tmp_path), n_slots=N_SLOTS,
                                    max_len=MAX_LEN)
    with counters.capture("trace_calls", "plan_calls", "state_plan_calls") as cap:
        off = _engine("qwen3-0.6b", state_residency=False,
                      session=PlanSession.from_manifest(tmp_path))
    assert cap.deltas() == {"trace_calls": 1, "plan_calls": 0, "state_plan_calls": 0}
    rep = off.memory_report
    assert rep.plan_source == "bundle" and rep.aot_executables == ()
    assert rep.aot_warning is None and rep.bundle_warning is None
    assert _serve(off, "qwen3-0.6b", None) == _serve(_engine("qwen3-0.6b"),
                                                     "qwen3-0.6b", None)


def test_the_decode_lint_runs_on_a_residency_off_engine():
    eng = _engine("qwen3-0.6b", block_size=4, state_residency=False)
    prompts, new = _prompts(_params("qwen3-0.6b")[2], None)
    for p in prompts:
        eng.submit(p, max_new_tokens=new)
    assert decode_lint.lint_run(eng, eng.run_until_done) == []


def test_serve_cli_no_residency():
    args = ["--device", "cpu", "--requests", "3", "--slots", str(N_SLOTS),
            "--max-len", str(MAX_LEN), "--prompt-len", "4", "--max-new", "3"]
    base = serve.run(args)
    off = serve.run(args + ["--no-residency"])
    assert base["state_residency"] is True and off["state_residency"] is False
    assert off["tokens_per_request"] == base["tokens_per_request"]
    assert off["state_ptr_before"] is None and off["arena_ptr_before"] is None
    assert off["allocated_bytes"] == off["state_live_bytes"] == base["state_live_bytes"]
    with pytest.warns(RuntimeWarning, match="paged state requires state residency"):
        paged = serve.run(args + ["--no-residency", "--page-size", "1024"])
    assert paged["tokens_per_request"] == base["tokens_per_request"]
    assert paged["page_size"] is None
