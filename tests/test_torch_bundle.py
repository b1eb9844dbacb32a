"""Engines served from the port's plan bundles, against the port's
plan-at-construction engine and the JAX engine.

Reduced configs in float32, 2 slots x 48 positions, bundles compiled by
``repro_torch.launch.compile`` (the decode step traced on ``meta``)
without their AOT decode program (``aot=False``; the bundles that carry
one are ``tests/test_torch_aot.py``'s): qwen3 symmetric and paged (pages
of 1 KiB), gemma3 paged with its window cut to 8 (every ring wraps),
mamba2. Each bundle-served engine:

* takes both halves from the bundle: ``plan_calls`` 0,
  ``state_plan_calls`` 0, and ``trace_calls`` exactly 1 (the executor's
  program), ``plan_source`` "bundle";
* has activation and state plans byte-identical (``plan_io`` /
  ``state_plan_to_obj`` JSON) to the construction engine's, under the
  same fingerprint;
* serves tokens equal to the construction engine's and the JAX engine's.

The fallbacks never raise and say why in ``bundle_warning``: a manifest
the reference published, a missing or corrupt bundle, another serve
configuration, another cores, a graph fingerprint that is not the
trace's, a searched activation plan; the legacy kwargs warn.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro.runtime import engine as jax_engine_mod  # noqa: E402
from repro_torch.analysis import counters, soundness  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core import plan_io, unified  # noqa: E402
from repro_torch.core.artifact import (BundleManifest, bucket_key,  # noqa: E402
                                       save_bundle, serve_fingerprint)
from repro_torch.core.unified import PlanSession, PlanSpec, state_plan_to_obj  # noqa: E402
from repro_torch.launch import compile as compile_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

N_SLOTS, MAX_LEN = 2, 48
# case -> (arch, window cut or None, page size or None)
CASES = {
    "qwen3": ("qwen3-0.6b", None, None),
    "qwen3_paged": ("qwen3-0.6b", None, 1024),
    "gemma3_paged_window8": ("gemma3-4b", 8, 1024),
    "mamba2": ("mamba2-2.7b", None, None),
}
COUNTERS = ("trace_calls", "plan_calls", "state_plan_calls")


def _windowed(cfg, window):
    if window is None:
        return cfg

    def cut(specs):
        return tuple(dataclasses.replace(s, window=window) if s.window else s
                     for s in specs)
    return dataclasses.replace(cfg, period=cut(cfg.period), remainder=cut(cfg.remainder))


@functools.lru_cache(maxsize=None)
def _params(arch, window):
    jcfg = _windowed(jax_get_reduced(arch), window)
    cfg = _windowed(get_reduced(arch), window)
    jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _prompts(cfg, window):
    """Five requests through two slots; with a cut window they run each
    slot past it."""
    sizes, new = ((4, 12, 3, 9, 4), 9) if window else ((4, 6, 3, 5, 4), 5)
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in sizes], new


def _serve(engine, prompts, new):
    for p in prompts:
        engine.submit(p, max_new_tokens=new)
    return {r.request_id: list(r.tokens) for r in engine.run_until_done(
        raise_on_exhausted=True)}


def _engine(case, **kw):
    arch, window, page = CASES[case]
    cfg, params = _params(arch, window)[2:]
    return InferenceEngine(cfg, params, n_slots=kw.pop("n_slots", N_SLOTS),
                           max_len=kw.pop("max_len", MAX_LEN), device="cpu",
                           page_size=page, **kw)


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    """case -> a manifest directory holding the case's one bucket, with no
    AOT program (the engine traces its step). The window-cut gemma3 is no
    registry config, so its bundle skips the publish gate's freshness
    check (its plans are certified below)."""
    out = {}
    for case, (arch, window, page) in CASES.items():
        d = tmp_path_factory.mktemp(case)
        cfg = _params(arch, window)[2]
        compile_mod.compile_and_publish(cfg, str(d), n_slots=N_SLOTS, max_len=MAX_LEN,
                                        page_size=page, lint=window is None,
                                        aot=False)
        out[case] = d
    return out


def _bundle(manifests, case):
    arch, window, page = CASES[case]
    cfg = _params(arch, window)[2]
    return BundleManifest(manifests[case]).lookup(
        bucket_key(cfg, n_slots=N_SLOTS, max_len=MAX_LEN, page_size=page))


# ------------------------------------------------------- served from bundles


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_engine_plans_nothing_and_traces_once(manifests, case):
    with counters.capture(*COUNTERS) as cap:
        eng = _engine(case, session=PlanSession.from_manifest(manifests[case]))
    assert cap.deltas() == {"trace_calls": 1, "plan_calls": 0, "state_plan_calls": 0}
    rep = eng.memory_report
    assert rep.plan_source == "bundle" and rep.bundle_warning is None
    assert rep.state_plan_s is None and rep.plan_resolve_s > 0
    assert "precompiled bundle" in rep.summary()
    assert eng.plan_bundle is not None
    assert rep.state_plan == eng.plan_bundle.state_plan
    assert eng.unified_plan.total_size == eng.plan_bundle.total_size
    assert soundness.certify_bundle(eng.plan_bundle) == []


def _plan_json(plan):
    obj = plan_io.plan_to_obj(plan)
    obj["plan_wall_s"] = 0.0  # measurement, not plan content
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_plans_and_fingerprint_are_the_construction_engines(manifests, case):
    got = _engine(case, session=PlanSession.from_manifest(manifests[case]))
    want = _engine(case)
    assert _plan_json(got.memory_report.activation_plan) == \
        _plan_json(want.memory_report.activation_plan)
    assert json.dumps(state_plan_to_obj(got.memory_report.state_plan)) == \
        json.dumps(state_plan_to_obj(want.memory_report.state_plan))
    bundle = _bundle(manifests, case)
    assert got.unified_plan.fingerprint == want.unified_plan.fingerprint == \
        bundle.fingerprint
    # a bucketed spec over the same graph carries the bundle's key
    arch, window, page = CASES[case]
    spec = PlanSpec(graph=want.decode_graph, cfg=_params(arch, window)[2],
                    n_slots=N_SLOTS, max_len=MAX_LEN,
                    serve_params=serve_fingerprint(page_size=page))
    assert unified.plan(spec).fingerprint == bundle.fingerprint


@pytest.mark.parametrize("case", list(CASES))
def test_bundle_engine_tokens_equal_construction_and_jax(manifests, case):
    arch, window, page = CASES[case]
    jcfg, jparams, cfg, _ = _params(arch, window)
    prompts, new = _prompts(cfg, window)
    got = _serve(_engine(case, session=PlanSession.from_manifest(manifests[case])),
                 prompts, new)
    assert got == _serve(_engine(case), prompts, new)
    jeng = jax_engine_mod.InferenceEngine(jcfg, jparams, n_slots=N_SLOTS,
                                          max_len=MAX_LEN, page_size=page)
    assert got == _serve(jeng, prompts, new)


def test_a_longer_compiled_bucket_serves_a_shorter_request(manifests):
    eng = _engine("qwen3", max_len=40, session=PlanSession.from_manifest(
        manifests["qwen3"]))
    assert eng.memory_report.plan_source == "bundle" and eng.max_len == MAX_LEN
    exact = _engine("qwen3", max_len=40, session=PlanSession.from_manifest(
        manifests["qwen3"], nearest=False))
    _assert_fell_back(exact, "unusable")


# --------------------------------------------------------------- fallbacks


def _assert_fell_back(eng, match):
    rep = eng.memory_report
    assert rep.plan_source in ("planned", "cache")
    assert rep.bundle_warning is not None and match in rep.bundle_warning
    assert f"WARNING: {rep.bundle_warning}" in rep.summary()


def _qwen3_tokens(eng):
    cfg = _params("qwen3-0.6b", None)[2]
    return _serve(eng, *_prompts(cfg, None))


def test_a_manifest_the_reference_published_falls_back(tmp_path):
    """The reference's bundle for the same bucket (its bucket key is the
    port's) is refused by fingerprint: its plan covers a jaxpr's records."""
    from repro.launch.compile import compile_and_publish as jax_compile_and_publish

    jcfg = _params("qwen3-0.6b", None)[0]
    jax_compile_and_publish(jcfg, str(tmp_path), n_slots=N_SLOTS, max_len=MAX_LEN,
                            measure_xla=False, aot=False)
    with counters.capture(*COUNTERS) as cap:
        eng = _engine("qwen3", session=PlanSession.from_manifest(tmp_path))
    _assert_fell_back(eng, "plan bundle fingerprint mismatch")
    assert cap.deltas() == {"trace_calls": 1, "plan_calls": 1, "state_plan_calls": 1}
    assert _qwen3_tokens(eng) == _qwen3_tokens(_engine("qwen3"))


@pytest.mark.parametrize("name,text", [("bad.json", "{not json"),
                                       ("list.json", "[1, 2, 3]"),
                                       ("shallow.json", '{"format_version": 4}')])
def test_corrupt_bundle_files_fall_back(tmp_path, name, text):
    bad = tmp_path / name
    bad.write_text(text)
    eng = _engine("qwen3", session=PlanSession.from_bundle(bad))
    _assert_fell_back(eng, "unusable")


def test_a_missing_bucket_falls_back_and_lists_what_exists(tmp_path, manifests):
    _assert_fell_back(_engine("qwen3", session=PlanSession.from_manifest(tmp_path)),
                      "manifest is empty")
    # the paged bucket is another family: a symmetric engine misses it
    eng = _engine("qwen3", session=PlanSession.from_manifest(manifests["qwen3_paged"]))
    _assert_fell_back(eng, "|page1024")


# another serve configuration or another cores: the fingerprint differs
OTHER_CONFIG = [
    (dict(block_size=4), dict()),
    (dict(greedy=False, temperature=0.8, top_k=5), dict()),
    (dict(cores="plain"), dict()),
    (dict(), dict(cores="plain")),
]


@pytest.mark.parametrize("compiled,served", OTHER_CONFIG)
def test_another_serve_configuration_falls_back(tmp_path, compiled, served):
    cfg = _params("qwen3-0.6b", None)[2]
    compile_mod.compile_and_publish(cfg, str(tmp_path), n_slots=N_SLOTS,
                                    max_len=MAX_LEN, **compiled)
    eng = _engine("qwen3", session=PlanSession.from_manifest(tmp_path), **served)
    _assert_fell_back(eng, "plan bundle fingerprint mismatch")
    same = _engine("qwen3", session=PlanSession.from_manifest(tmp_path), **compiled)
    assert same.memory_report.plan_source == "bundle"


def test_a_graph_fingerprint_other_than_the_trace_falls_back(tmp_path, manifests):
    tampered = dataclasses.replace(_bundle(manifests, "qwen3"),
                                   graph_fingerprint="0" * 64)
    f = tmp_path / "tampered.json"
    save_bundle(tampered, f)
    with counters.capture(*COUNTERS) as cap:
        eng = _engine("qwen3", session=PlanSession.from_bundle(f, verify_graph=True))
    _assert_fell_back(eng, "plan bundle graph fingerprint mismatch")
    # both halves planned here; the state layout is the bundle's, so the
    # one trace stands
    assert cap.deltas() == {"trace_calls": 1, "plan_calls": 1, "state_plan_calls": 1}
    assert _qwen3_tokens(eng) == _qwen3_tokens(_engine("qwen3"))


def test_a_searched_bundle_falls_back(tmp_path):
    cfg = _params("qwen3-0.6b", None)[2]
    res = compile_mod.compile_and_publish(cfg, str(tmp_path), n_slots=N_SLOTS,
                                          max_len=MAX_LEN, search=True,
                                          search_iters=30, fusion_rounds=5)
    assert res.bundle.plan.total_size <= res.greedy_plan.total_size
    assert res.bundle.provenance["search_stats"]
    # the search found nothing smaller: program order, served
    assert res.bundle.order is None and res.bundle.fusion_groups is None
    eng = _engine("qwen3", session=PlanSession.from_manifest(tmp_path))
    assert eng.memory_report.plan_source == "bundle"
    for searched in (dict(order=list(range(len(res.graph.ops)))[::-1]),
                     dict(fusion_groups=[[0, 1]] + [[i] for i in range(
                         2, len(res.graph.ops))])):
        f = tmp_path / "searched.json"
        save_bundle(dataclasses.replace(res.bundle, **searched), f)
        eng = _engine("qwen3", session=PlanSession.from_bundle(f))
        _assert_fell_back(eng, "searched activation plan")
        assert "A24" in eng.memory_report.bundle_warning


def test_the_legacy_kwargs_warn_and_serve(manifests):
    with pytest.deprecated_call(match="session=PlanSession"):
        eng = _engine("qwen3", plan_bundle=manifests["qwen3"])
    assert eng.memory_report.plan_source == "bundle"
    with pytest.deprecated_call(match="session=PlanSession"):
        eng = _engine("qwen3", plan_bundle=manifests["qwen3"], verify_bundle=True)
    assert eng.memory_report.plan_source == "bundle"
    with pytest.deprecated_call(match="plan_strategy"):
        eng = _engine("qwen3", plan_strategy="greedy_by_size")
    assert eng.memory_report.plan_source in ("planned", "cache")
    assert eng.memory_report.activation_plan.strategy == "greedy_by_size"
    with pytest.raises(ValueError, match="not both"):
        _engine("qwen3", session=PlanSession.from_manifest(manifests["qwen3"]),
                plan_bundle=manifests["qwen3"])


def test_a_spec_session_plans_from_its_graph(manifests):
    """``PlanSession.from_spec`` with the traced graph: the spec's plan is
    served (its records are the trace's); with other records it falls
    back."""
    graph = _engine("qwen3").decode_graph
    eng = _engine("qwen3", session=PlanSession.from_spec(PlanSpec(graph=graph)))
    rep = eng.memory_report
    assert rep.plan_source in ("planned", "cache") and rep.bundle_warning is None
    other = _engine("mamba2").decode_graph
    eng = _engine("qwen3", session=PlanSession.from_spec(PlanSpec(graph=other)))
    _assert_fell_back(eng, "does not cover")


# ----------------------------------------------------------- the entry points


def test_serve_cli_from_a_manifest(manifests):
    args = ["--device", "cpu", "--requests", "3", "--slots", str(N_SLOTS),
            "--max-len", str(MAX_LEN), "--prompt-len", "4", "--max-new", "3"]
    base = serve.run(args)
    for case, extra in (("qwen3", []), ("qwen3_paged", ["--page-size", "1024"])):
        stats = serve.run(args + extra + ["--plan-bundle", str(manifests[case]),
                                          "--compare-cold-start"])
        assert stats["plan_source"] == "bundle" and stats["bundle_warning"] is None
        assert (stats["trace_calls"], stats["plan_calls"],
                stats["state_plan_calls"]) == (1, 0, 0)
        assert stats["state_plan_s"] is None
        assert stats["cold_start_noartifact_s"] > 0
        assert stats["tokens_per_request"] == base["tokens_per_request"]
    assert base["plan_source"] in ("planned", "cache") and base["state_plan_s"] > 0
    assert (base["trace_calls"], base["plan_calls"], base["state_plan_calls"]) == \
        (1, 1, 1)


def test_serve_cli_compile_first(tmp_path):
    stats = serve.run(["--device", "cpu", "--requests", "2", "--slots", "2",
                       "--max-len", "32", "--prompt-len", "4", "--max-new", "2",
                       "--compile-first", "--plan-bundle", str(tmp_path)])
    assert stats["plan_source"] == "bundle"
    assert (tmp_path / "manifest.json").is_file()


def test_compile_cli_publishes_what_lint_passes(tmp_path, capsys):
    from repro_torch.analysis.lint import main as lint_main

    out = tmp_path / "m"
    compile_mod.main(["--arch", "qwen3-0.6b", "--slots", "2", "--max-len", "32",
                      "--page-size", "1024", "--out", str(out), "--json"])
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["state_total_bytes"] > 0 and row["records"] > 0
    assert lint_main(["bundles", str(out)]) == 0
    compile_mod.main(["--all", "--archs", "qwen3-0.6b", "mamba2-2.7b",
                      "--slots-list", "2", "--max-lens", "16", "32", "--out", str(out)])
    assert len(BundleManifest(out).buckets()) == 5
    assert lint_main(["--strict", "bundles", str(out)]) == 0
