"""AOT decode programs in the port's plan bundles (``runtime/aot.py``):
an engine served from a bundle that carries its program traces nothing.

Twin of ``tests/test_aot.py``. Reduced configs in float32, 2 slots x 48
positions, bundles compiled by ``repro_torch.launch.compile`` with the
program packed (the default): qwen3 symmetric and paged (pages of 1 KiB),
gemma3 paged with its window cut to 8 (every ring wraps), mamba2.

* a bundle with its program serves with ``trace_calls``, ``plan_calls``
  and ``state_plan_calls`` all 0, tokens equal to the plan-at-construction
  engine's and the JAX engine's, and in blocks of 8 equal to the host
  loop; ``verify_graph=True`` traces once;
* a stale, corrupt, undeserializable, foreign-graph or reference pack is
  refused whole with one ``RuntimeWarning``, and the engine traces once
  and serves the same tokens;
* a program saved on ``meta`` loads onto the CPU with the fresh trace's
  ``graph_fingerprint``, every value and device argument retargeted, and
  its pack is under 1 MB (no example inputs);
* ``decode_lint.lint_executables`` is clean on a fresh pack and finds an
  undeserializable payload, another bucket's program, a host transfer
  and a state that is not written in place; ``bundle_lint`` checks the
  port's key and its one entry.
"""

import dataclasses
import functools
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro.runtime import engine as jax_engine_mod  # noqa: E402
from repro_torch.analysis import bundle_lint, counters, decode_lint  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core import artifact  # noqa: E402
from repro_torch.core.artifact import (BundleManifest, bucket_key,  # noqa: E402
                                       bundle_from_json, bundle_to_json,
                                       executable_entry, graph_fingerprint,
                                       save_bundle)
from repro_torch.core.unified import PlanSession  # noqa: E402
from repro_torch.launch import compile as compile_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.runtime import aot  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402
from repro_torch.trace.fx_liveness import trace_fx  # noqa: E402

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
    return InferenceEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                           device="cpu", page_size=page, **kw)


def _tokens(case, engine):
    arch, window, _ = CASES[case]
    return _serve(engine, *_prompts(_params(arch, window)[2], window))


def _compile(case, out, **kw):
    arch, window, page = CASES[case]
    cfg = _params(arch, window)[2]
    # the window-cut gemma3 is no registry config: its bundle skips the
    # publish gate's freshness check, and its program is linted below
    return compile_mod.compile_and_publish(cfg, str(out), n_slots=N_SLOTS,
                                           max_len=MAX_LEN, page_size=page,
                                           lint=window is None, **kw)


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    """case -> a manifest directory holding the case's bucket, compiled
    with its program."""
    out = {}
    for case in CASES:
        out[case] = tmp_path_factory.mktemp(case)
        _compile(case, out[case])
    return out


def _bundle(manifests, case):
    arch, window, page = CASES[case]
    cfg = _params(arch, window)[2]
    return BundleManifest(manifests[case]).lookup(
        bucket_key(cfg, n_slots=N_SLOTS, max_len=MAX_LEN, page_size=page))


def _from(bundle, tmp_path, **kw):
    f = tmp_path / "bundle.json"
    save_bundle(bundle, f)
    return PlanSession.from_bundle(f, **kw)


# ------------------------------------------------------- served from programs


@pytest.mark.parametrize("case", list(CASES))
def test_a_bundle_with_its_program_traces_and_plans_nothing(manifests, case):
    with counters.capture(*COUNTERS) as cap:
        eng = _engine(case, session=PlanSession.from_manifest(manifests[case]))
    assert cap.deltas() == {"trace_calls": 0, "plan_calls": 0, "state_plan_calls": 0}
    rep = eng.memory_report
    entry = aot.decode_entry(CASES[case][2] is not None)
    assert rep.aot_executables == (entry,) and rep.aot_warning is None
    assert rep.plan_source == "bundle" and rep.bundle_warning is None
    assert rep.trace_s is None and rep.aot_load_s > 0
    assert rep.capture_calls == 0  # nothing is captured on the CPU
    assert f"AOT decode program(s) loaded from the bundle" in rep.summary()
    assert graph_fingerprint(eng.decode_graph) == eng.plan_bundle.graph_fingerprint
    assert eng.executor.trace.gm is not None


@pytest.mark.parametrize("case", list(CASES))
def test_program_tokens_equal_the_construction_and_jax_engines(manifests, case):
    arch, window, page = CASES[case]
    jcfg, jparams = _params(arch, window)[:2]
    got = _tokens(case, _engine(case, session=PlanSession.from_manifest(manifests[case])))
    want = _engine(case)
    assert want.memory_report.trace_s > 0
    assert got == _tokens(case, want)
    jeng = jax_engine_mod.InferenceEngine(jcfg, jparams, n_slots=N_SLOTS,
                                          max_len=MAX_LEN, page_size=page)
    assert got == _tokens(case, jeng)


@pytest.mark.parametrize("case", list(CASES))
def test_blocks_of_8_from_a_program_equal_the_host_loop(manifests, tmp_path, case):
    _compile(case, tmp_path, block_size=8)
    with counters.capture(*COUNTERS) as cap:
        eng = _engine(case, block_size=8, session=PlanSession.from_manifest(tmp_path))
    assert cap.deltas() == {"trace_calls": 0, "plan_calls": 0, "state_plan_calls": 0}
    assert eng.memory_report.aot_executables
    host = _engine(case, session=PlanSession.from_manifest(manifests[case]))
    assert _tokens(case, eng) == _tokens(case, host)
    assert eng.n_blocks > 0


@pytest.mark.parametrize("case", list(CASES))
def test_verify_graph_traces_once(manifests, case):
    with counters.capture(*COUNTERS) as cap:
        eng = _engine(case, session=PlanSession.from_manifest(manifests[case],
                                                              verify_graph=True))
    assert cap.deltas() == {"trace_calls": 1, "plan_calls": 0, "state_plan_calls": 0}
    rep = eng.memory_report
    assert rep.aot_executables and rep.trace_s > 0 and rep.bundle_warning is None
    assert _tokens(case, eng) == _tokens(case, _engine(case))


def test_verify_graph_against_another_graph_falls_back(manifests, tmp_path):
    """A bundle whose graph fingerprint is not the step's: the fresh trace
    refuses it, and the loaded program goes with it."""
    b = _bundle(manifests, "qwen3")
    tampered = dataclasses.replace(b, graph_fingerprint="0" * 64)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng = _engine("qwen3", session=_from(tampered, tmp_path, verify_graph=True))
    rep = eng.memory_report
    # the program is not the tampered bundle's graph: refused at load
    assert "not the bundle's graph" in rep.aot_warning
    assert [str(x.message) for x in w if x.category is RuntimeWarning] == [rep.aot_warning]
    assert "graph fingerprint mismatch" in rep.bundle_warning
    assert rep.aot_executables == () and rep.plan_source in ("planned", "cache")


# --------------------------------------------------------------- refusals


def _stale(pack):
    return dataclasses.replace(pack, torch_version="0.0.0+other")


def _corrupt(pack):
    return dataclasses.replace(pack, entries={
        n: dataclasses.replace(e, payload=e.payload[:-1] + b"?")
        for n, e in pack.entries.items()})


def _garbage(pack):
    return dataclasses.replace(pack, entries={
        n: executable_entry(b"not a saved program") for n in pack.entries})


def _reference(pack):
    return artifact.ExecutablePack(
        platform="cpu", jax_version=jax.__version__,
        entries={n: executable_entry(b"x" * 7)
                 for n in artifact.expected_executable_entries()})


def _other_graph(pack, manifests):
    other = _bundle(manifests, "mamba2").executables.entries
    return dataclasses.replace(pack, entries={
        n: other["resident_decode"] for n in pack.entries})


REFUSALS = {
    "stale_torch": (_stale, "compiled under torch 0.0.0+other"),
    "corrupt": (_corrupt, "failed its payload integrity check"),
    "undeserializable": (_garbage, "failed to deserialize"),
    "reference_pack": (_reference, "not by repro_torch"),
    "other_graph": (_other_graph, "not the bundle's graph"),
}


@pytest.mark.parametrize("kind", list(REFUSALS))
def test_a_refused_pack_warns_once_traces_once_and_serves(manifests, tmp_path, kind):
    mutate, match = REFUSALS[kind]
    b = _bundle(manifests, "qwen3")
    pack = mutate(b.executables, manifests) if kind == "other_graph" else \
        mutate(b.executables)
    with counters.capture(*COUNTERS) as cap:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            eng = _engine("qwen3", session=_from(
                dataclasses.replace(b, executables=pack), tmp_path))
    rep = eng.memory_report
    assert match in rep.aot_warning and "falling back to tracing" in rep.aot_warning
    assert [str(x.message) for x in w if x.category is RuntimeWarning] == [rep.aot_warning]
    assert f"WARNING: {rep.aot_warning}" in rep.summary()
    # refused whole: nothing loaded, the plans still from the bundle
    assert rep.aot_executables == () and rep.plan_source == "bundle"
    assert cap.deltas() == {"trace_calls": 1, "plan_calls": 0, "state_plan_calls": 0}
    assert rep.trace_s > 0
    assert _tokens("qwen3", eng) == _tokens("qwen3", _engine("qwen3"))


def test_a_pack_without_this_buckets_entry_is_refused(manifests, tmp_path):
    """The symmetric bucket's program in the paged bundle: another entry
    name, refused before anything loads."""
    b = _bundle(manifests, "qwen3_paged")
    pack = dataclasses.replace(b.executables, entries=dict(
        _bundle(manifests, "qwen3").executables.entries))
    with pytest.warns(RuntimeWarning, match="this bucket's is"):
        eng = _engine("qwen3_paged", session=_from(
            dataclasses.replace(b, executables=pack), tmp_path))
    assert eng.memory_report.aot_executables == ()


def test_inputs_the_program_does_not_take_are_named():
    cfg = get_reduced("qwen3-0.6b")
    prog = compile_mod._decode_program(cfg, n_slots=N_SLOTS, max_len=MAX_LEN)
    tr = aot.deserialize_program(aot.serialize_program(prog.trace(), prog.args),
                                 device="meta", name="p")
    assert aot.inputs_mismatch(tr, prog.args) is None
    args = list(prog.args)
    args[2] = torch.zeros((N_SLOTS + 1, 1), dtype=torch.int32, device="meta")
    assert "input" in aot.inputs_mismatch(tr, tuple(args))
    args = list(prog.args)
    args[1] = dict(args[1], extra=torch.zeros(1, device="meta"))
    assert "structure" in aot.inputs_mismatch(tr, tuple(args))


# ------------------------------------------------------- the program itself


@pytest.mark.parametrize("case", list(CASES))
def test_a_program_from_meta_has_the_fresh_fingerprint_on_the_cpu(manifests, case):
    b = _bundle(manifests, case)
    (name, entry), = b.executables.entries.items()
    assert entry.nbytes < 1_000_000  # the params are inputs, not carried
    assert b.executables.key.startswith("repro_torch torch ") and \
        b.executables.device_type == "meta"
    tr = aot.deserialize_program(entry.payload, device="cpu", name=name)
    fresh = _engine(case).decode_graph
    assert graph_fingerprint(tr.graph) == graph_fingerprint(fresh) == b.graph_fingerprint
    for node in tr.gm.graph.nodes:
        val = node.meta.get("val")
        for v in (val if isinstance(val, (tuple, list)) else (val,)):
            if isinstance(v, torch.Tensor):
                assert v.device.type == "cpu", node
        devices = [a for a in list(node.args) + list(node.kwargs.values())
                   if isinstance(a, torch.device)]
        assert all(d.type == "cpu" for d in devices), node


def test_the_pack_round_trips_with_the_ports_key(manifests):
    b = _bundle(manifests, "qwen3_paged")
    obj = artifact.executables_to_obj(b.executables)
    assert {"runtime", "torch_version", "device_type"} <= set(obj)
    assert "platform" not in obj and "jax_version" not in obj
    assert obj["runtime"] == "repro_torch" and obj["torch_version"] == torch.__version__
    b2 = bundle_from_json(bundle_to_json(b))
    assert bundle_to_json(b2) == bundle_to_json(b)
    assert b2.executables.is_port and sorted(b2.executables.entries) == ["paged_decode"]
    assert "repro_torch torch" in b.summary()
    assert aot.expected_executable_entries(paged=True) == ["paged_decode"]


def test_build_decode_executables_traces_the_bucket_on_meta(manifests):
    cfg = get_reduced("qwen3-0.6b")
    b = _bundle(manifests, "qwen3")
    with counters.capture("trace_calls") as cap:
        pack = aot.build_decode_executables(cfg, b.state_plan, n_slots=N_SLOTS,
                                            max_len=MAX_LEN)
    assert cap.delta("trace_calls") == 1
    assert sorted(pack.entries) == ["resident_decode"] and pack.is_port
    assert decode_lint.lint_executables(dataclasses.replace(b, executables=pack)) == []


def test_compile_traces_once_and_no_aot_packs_nothing(tmp_path):
    cfg = get_reduced("qwen3-0.6b")
    with counters.capture("trace_calls") as cap:
        res = compile_mod.compile_decode_plan(cfg, n_slots=N_SLOTS, max_len=MAX_LEN)
    assert cap.delta("trace_calls") == 1 and res.bundle.executables is not None
    res = compile_mod.compile_decode_plan(cfg, n_slots=N_SLOTS, max_len=MAX_LEN,
                                          aot=False)
    assert res.bundle.executables is None


# ----------------------------------------------------------------- lints


@pytest.mark.parametrize("case", list(CASES))
def test_lint_executables_is_clean_on_a_fresh_pack(manifests, case):
    b = _bundle(manifests, case)
    assert decode_lint.lint_executables(b) == []
    codes = {f.code for f in bundle_lint.lint_bundle(b)}
    assert not {c for c in codes if c.startswith("executable")}


def _codes(bundle):
    return {f.code for f in decode_lint.lint_executables(bundle)}


def test_lint_executables_finds_a_load_failure_and_another_graph(manifests):
    b = _bundle(manifests, "qwen3")
    assert _codes(dataclasses.replace(b, executables=_garbage(b.executables))) == \
        {"executable-load-failed"}
    assert _codes(dataclasses.replace(
        b, executables=_other_graph(b.executables, manifests))) == \
        {"executable-graph-mismatch"}
    # a reference pack is not the port's to load
    assert _codes(dataclasses.replace(b, executables=_reference(b.executables))) == set()


def _planted(fn, b):
    """``b`` with the program of ``fn`` over the qwen3 bucket's arguments."""
    cfg = get_reduced("qwen3-0.6b")
    prog = compile_mod._decode_program(cfg, n_slots=N_SLOTS, max_len=MAX_LEN)
    tr = trace_fx(fn(prog.fn), *prog.args)
    pack = dataclasses.replace(b.executables, entries={
        "resident_decode": executable_entry(aot.serialize_program(tr, prog.args))})
    return dataclasses.replace(b, executables=pack,
                               graph_fingerprint=graph_fingerprint(tr.graph))


def test_lint_executables_finds_a_host_transfer(manifests):
    def to_host(step):
        def fn(p, tables, t, c, pos, act):
            logits, c = step(p, tables, t, c, pos, act)
            return logits.to("cpu"), c
        return fn

    assert _codes(_planted(to_host, _bundle(manifests, "qwen3"))) == {"host-transfer"}


def test_lint_executables_finds_a_state_not_written_in_place(manifests):
    def fresh_state(step):
        def fn(p, tables, t, c, pos, act):
            logits, c = step(p, tables, t, c, pos, act)
            return logits, torch.utils._pytree.tree_map(lambda x: x * 1, c)
        return fn

    assert _codes(_planted(fresh_state, _bundle(manifests, "qwen3"))) == \
        {"state-not-donated"}


def test_bundle_lint_checks_the_ports_key_and_entry(manifests):
    b = _bundle(manifests, "qwen3")
    keyless = dataclasses.replace(b.executables, torch_version=None)
    assert "executable-key-missing" in {
        f.code for f in bundle_lint.lint_bundle(dataclasses.replace(b, executables=keyless))}
    empty = dataclasses.replace(b.executables, entries={})
    assert "executable-missing" in {
        f.code for f in bundle_lint.lint_bundle(dataclasses.replace(b, executables=empty))}


def test_lint_bundles_cli_loads_the_programs(manifests, tmp_path, capsys):
    from repro_torch.analysis.lint import main as lint_main

    assert lint_main(["--json", "bundles", str(manifests["qwen3_paged"])]) == 0
    report = json.loads(capsys.readouterr().out)
    assert any(c.startswith("decode_lint:executables") for c in report["checked"])
    b = _bundle(manifests, "qwen3")
    f = tmp_path / "garbage.json"
    save_bundle(dataclasses.replace(b, executables=_garbage(b.executables)), f)
    assert lint_main(["bundles", str(f)]) == 1
    assert "executable-load-failed" in capsys.readouterr().out


# ------------------------------------------------------------ entry points


def test_serve_cli_reports_the_program(manifests, tmp_path):
    args = ["--device", "cpu", "--requests", "3", "--slots", str(N_SLOTS),
            "--max-len", str(MAX_LEN), "--prompt-len", "4", "--max-new", "3"]
    base = serve.run(args)
    assert base["aot_executables"] == [] and base["trace_s"] > 0
    stats = serve.run(args + ["--plan-bundle", str(manifests["qwen3"])])
    assert stats["aot_executables"] == ["resident_decode"]
    assert stats["aot_warning"] is None and stats["trace_s"] is None
    assert stats["aot_load_s"] > 0 and stats["state_residency"] is True
    assert (stats["trace_calls"], stats["plan_calls"], stats["state_plan_calls"]) == \
        (0, 0, 0)
    assert stats["tokens_per_request"] == base["tokens_per_request"]
    out = tmp_path / "m"
    compile_mod.main(["--arch", "qwen3-0.6b", "--slots", "2", "--max-len", "32",
                      "--no-aot", "--out", str(out)])
    (entry,) = BundleManifest(out).buckets().values()
    assert artifact.load_bundle(out / entry["file"]).executables is None

