"""The port's soundness certifier, state-axis probe and engine gate.

``repro_torch.analysis.soundness`` gives the finding codes of the JAX
package's certifier on the ``graph_gen`` corpus (valid plans: none) and
on planted faults in offsets, shared-objects, state and paged-state
plans; it certifies the port's own traced decode plans, state plans and
traced prefill with zero findings. ``detect_state_axes`` evaluates
``init_cache`` on ``meta`` tensors and equals the JAX probe on the reduced
and full-width qwen3 and mamba2 templates. An engine built with
``startup_lint=True`` serves, and refuses a plan with a planted overlap.
"""

import dataclasses
import inspect
import re

import pytest

torch = pytest.importorskip("torch")

import graph_gen  # noqa: E402
from repro.analysis import soundness as jax_soundness  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.core import offsets as jax_offsets  # noqa: E402
from repro.core import shared_objects as jax_so  # noqa: E402
from repro.core import unified as jax_unified  # noqa: E402
from repro.core.records import TensorUsageRecord as JaxRecord  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro_torch.analysis import LintGateError, soundness  # noqa: E402
from repro_torch.configs.base import get_config, get_reduced  # noqa: E402
from repro_torch.core import offsets, shared_objects, unified  # noqa: E402
from repro_torch.core.records import TensorUsageRecord, make_records  # noqa: E402
from repro_torch.launch.compile import plan_prefill  # noqa: E402
from repro_torch.models.api import DecoderModel  # noqa: E402
from repro_torch.runtime import executor as executor_mod  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402

ARCHS = ["qwen3-0.6b", "mamba2-2.7b"]
CASES = [(kind, seed) for kind in sorted(graph_gen.GENERATORS) for seed in range(12)]


def _codes(findings):
    return sorted({f.code for f in findings})


def _to_port(records):
    return [TensorUsageRecord(r.first_op, r.last_op, r.size, r.tensor_id)
            for r in records]


def _ported(text: str) -> str:
    text = re.sub(r"\brepro\.", "repro_torch.", text)
    return re.sub(r"(from|import) repro\b(?!_torch)", r"\1 repro_torch", text)


@pytest.mark.parametrize("name", ["_SweepSet", "certify_offsets", "certify_shared_objects",
                                  "_positional_maximums_sum", "certify_state_plan",
                                  "_certify_paged_state", "certify_plan",
                                  "certify_unified"])
def test_certifier_is_the_reference(name):
    """The copy differs only in ``_leaf_nbytes`` (the port's dtype sizes,
    bfloat16 included, in place of the ml_dtypes fallback) and in the
    unused numpy imports it drops."""
    want = _ported(inspect.getsource(getattr(jax_soundness, name)))
    want = want.replace("    import numpy as np\n\n", "")
    assert inspect.getsource(getattr(soundness, name)) == want


# --------------------------------------------------- the corpus and faults


@pytest.mark.parametrize("kind,seed", CASES)
def test_same_codes_on_the_corpus_and_its_mutations(kind, seed):
    jrecs = graph_gen.generate(kind, seed)
    recs = _to_port(jrecs)
    asn = offsets.greedy_by_size_offsets(recs)
    assert asn.offsets == jax_offsets.greedy_by_size_offsets(jrecs).offsets
    mutations = [dict(asn.offsets)]
    rng = __import__("random").Random(seed)
    by_id = {r.tensor_id: r for r in recs}
    live = [(a, b) for a in recs for b in recs if a.tensor_id < b.tensor_id
            and a.overlaps(b)]
    if live:  # two simultaneously live tensors on the same bytes
        a, b = rng.choice(live)
        mutations.append({**asn.offsets, b.tensor_id: asn.offsets[a.tensor_id]})
    tid = rng.choice(sorted(by_id))
    mutations.append({**asn.offsets, tid: -by_id[tid].size})  # negative
    mutations.append({**asn.offsets, tid: asn.total_size})    # past the end
    mutations.append({k: v for k, v in asn.offsets.items() if k != tid})  # coverage
    for i, offs in enumerate(mutations):
        got = _codes(soundness.certify_offsets(recs, offs, asn.total_size))
        want = _codes(jax_soundness.certify_offsets(jrecs, offs, asn.total_size))
        assert got == want
        assert (got == []) == (i == 0)

    so = shared_objects.greedy_by_size(recs)
    jso = jax_so.greedy_by_size(jrecs)
    assert _codes(soundness.certify_shared_objects(recs, so)) == [] == _codes(
        jax_soundness.certify_shared_objects(jrecs, jso))
    if live:  # force two live tensors into one object, in both packages
        a, b = live[0]
        for s in (so, jso):
            s.assignment[b.tensor_id] = s.assignment[a.tensor_id]
        assert _codes(soundness.certify_shared_objects(recs, so)) == _codes(
            jax_soundness.certify_shared_objects(jrecs, jso)) != []


def _both(fn_name, *port_args):
    return (_codes(getattr(soundness, fn_name)(*port_args[0])),
            _codes(getattr(jax_soundness, fn_name)(*port_args[1])))


def test_offsets_and_shared_objects_fault_codes():
    from repro.core.records import make_records as jax_make_records
    from repro.core.shared_objects import SharedObject as JaxObject
    from repro.core.shared_objects import SharedObjectsAssignment as JaxAsn
    from repro_torch.core.shared_objects import SharedObject, SharedObjectsAssignment

    triples = [(0, 2, 64), (1, 3, 32)]
    recs, jrecs = make_records(triples), jax_make_records(triples)
    for offs, total, code in [({0: 0}, 96, "coverage"),
                              ({0: -1, 1: -1}, 96, "arena-collision"),
                              ({0: 0, 1: 80}, 96, "arena-spill"),
                              ({0: 0, 1: 64}, 128, "bounds")]:
        got, want = _both("certify_offsets", (recs, offs, total), (jrecs, offs, total))
        assert got == want and code in got
    for objs, asn, code in [([(0, 64)], {0: 0, 1: 0}, "object-collision"),
                            ([(0, 48), (1, 32)], {0: 0, 1: 1}, "object-size-mismatch"),
                            ([], {0: 0}, "coverage")]:
        p = SharedObjectsAssignment("synthetic", [SharedObject(object_id=i, size=s)
                                                  for i, s in objs], dict(asn))
        j = JaxAsn("synthetic", [JaxObject(object_id=i, size=s) for i, s in objs],
                   dict(asn))
        got, want = _both("certify_shared_objects", (recs, p), (jrecs, j))
        assert got == want and code in got


def _state_plans(mod):
    def plan(**kw):
        base = dict(
            n_slots=2, max_len=16, alignment=64,
            leaves=[mod.StateLeaf(path="a", shape=(2, 8, 8), dtype="float32",
                                  slot_nbytes=256, offset=0),
                    mod.StateLeaf(path="b", shape=(2, 4, 4), dtype="float32",
                                  slot_nbytes=64, offset=256)],
            slot_stride=320, total_size=640,
        )
        base.update(kw)
        return mod.StatePlan(**base)

    def leaf(i, **kw):
        p = plan()
        p.leaves[i] = dataclasses.replace(p.leaves[i], **kw)
        return p

    return [
        (plan(), None),
        (plan(alignment=0), "state-alignment"),
        (plan(total_size=641), "state-total-mismatch"),
        (plan(slot_stride=321, total_size=642), "state-stride-unaligned"),
        (leaf(0, slot_nbytes=192), "state-leaf-size"),
        (leaf(1, offset=288), "state-leaf-spill"),
        (leaf(1, offset=128), "state-leaf-collision"),
        (leaf(1, shape=(2, 4, 3), dtype="bfloat16", slot_nbytes=64), None),
    ]


@pytest.mark.parametrize("case", range(8))
def test_state_plan_fault_codes(case):
    port, code = _state_plans(unified)[case]
    jax_plan, _ = _state_plans(jax_unified)[case]
    got = _codes(soundness.certify_state_plan(port))
    assert got == _codes(jax_soundness.certify_state_plan(jax_plan))
    assert got == [] if code is None else code in got


def _paged(mod, page_size=64, page_pool=None):
    records = [
        mod.StateRecord(path="kv", shape=(2, 16, 8), dtype="float32",
                        nbytes=2 * 16 * 8 * 4),
        mod.StateRecord(path="ssm", shape=(2, 24), dtype="float32", nbytes=2 * 24 * 4),
    ]
    return mod.plan_paged_state(records, n_slots=2, max_len=16, page_size=page_size,
                                page_pool=page_pool,
                                axes={"kv": (0, 1), "ssm": (0, None)})


PAGED_MUTATIONS = [
    (lambda sp: {}, None),
    (lambda sp: {"page_offsets": [sp.page_offsets[0]] + sp.page_offsets[1:-1]
                 + [sp.page_offsets[0]]}, "paged-page-collision"),
    (lambda sp: {"page_offsets": [0] + sp.page_offsets[1:]}, "paged-page-collision"),
    (lambda sp: {"page_offsets": [sp.page_offsets[0] + 1] + sp.page_offsets[1:]},
     "paged-page-unaligned"),
    (lambda sp: {"page_offsets": sp.page_offsets[:-1] + [sp.phys_total_size]},
     "paged-page-spill"),
    (lambda sp: {"token_spans": sp.token_spans[:-1]}, "paged-span-size"),
    (lambda sp: {"token_spans": [(1, 8, 32)] + sp.token_spans[1:]}, "paged-span-size"),
    (lambda sp: {"n_pages_pool": 0, "page_offsets": []}, "paged-pool-empty"),
    (lambda sp: {"page_size": 0}, "paged-page-size"),
]


@pytest.mark.parametrize("case", range(len(PAGED_MUTATIONS)))
def test_paged_state_fault_codes(case):
    mutate, code = PAGED_MUTATIONS[case]
    port, jplan = _paged(unified), _paged(jax_unified)
    assert unified.state_plan_to_obj(port) == jax_unified.state_plan_to_obj(jplan)
    port = dataclasses.replace(port, **mutate(port))
    jplan = dataclasses.replace(jplan, **mutate(jplan))
    got = _codes(soundness.certify_state_plan(port))
    assert got == _codes(jax_soundness.certify_state_plan(jplan))
    assert got == [] if code is None else code in got


def test_a_short_pool_warns_in_both():
    got = soundness.certify_state_plan(_paged(unified, page_pool=2))
    want = jax_soundness.certify_state_plan(_paged(jax_unified, page_pool=2))
    assert [(f.code, f.severity) for f in got] == [(f.code, f.severity) for f in want]
    assert [f.code for f in got] == ["paged-pool-short"]


# -------------------------------------------------- the port's own plans


def _engine(arch, **kw):
    cfg = get_reduced(arch)
    params = DecoderModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    return InferenceEngine(cfg, params, n_slots=2, max_len=32, device="cpu", **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_traced_decode_and_state_plans_certify(arch):
    eng = _engine(arch, startup_lint=True)
    assert eng.memory_report.startup_lint_findings == 0
    assert eng.memory_report.startup_lint_s is not None
    up = eng.unified_plan
    assert soundness.certify_unified(up) == []
    assert soundness.certify_plan(up.activation) == []
    assert soundness.certify_state_plan(up.state) == []
    # the planner's Shared Objects mode over the same traced records
    so_plan = unified.plan(unified.PlanSpec(records=up.activation.records,
                                            mode="shared_objects"))
    assert soundness.certify_plan(so_plan.activation) == []
    # a paged layout of the same state, with the probed axes
    axes = unified.detect_state_axes(eng.model.init_cache, n_slots=2, max_len=32)
    records = unified.state_records_from_cache(eng.caches, n_slots=2)
    paged = unified.plan_paged_state(records, n_slots=2, max_len=32, page_size=256,
                                     axes=axes)
    assert soundness.certify_state_plan(paged) == []


def test_the_traced_prefill_plan_certifies():
    cfg = get_reduced("mamba2-2.7b")
    graph, plan = plan_prefill(cfg, prefill_len=300)  # certifies, or raises
    assert soundness.certify_plan(plan) == []
    assert len(plan.records) == len(graph.usage_records())


def test_unified_fingerprint_is_the_references():
    """Without a bucket config both packages key a spec by its content."""
    jrecs = graph_gen.generate("layered", 5)
    state = [("['a'][0]", (2, 4, 8), "float32", 256), ("['b']", (2, 3), "bfloat16", 12)]
    port = unified.plan(unified.PlanSpec(
        records=_to_port(jrecs), n_slots=2, max_len=8,
        state_records=[unified.StateRecord(*s) for s in state], use_cache=False))
    want = jax_unified.plan(jax_unified.PlanSpec(
        records=jrecs, n_slots=2, max_len=8,
        state_records=[jax_unified.StateRecord(*s) for s in state], use_cache=False))
    assert port.fingerprint == want.fingerprint
    assert port.total_size == want.total_size
    assert unified.state_plan_to_obj(port.state) == jax_unified.state_plan_to_obj(want.state)


# ------------------------------------------------------ detect_state_axes


def _axes_pair(cfg_port, cfg_jax, n_slots, max_len):
    model = DecoderModel(cfg_port, "cpu")
    got = unified.detect_state_axes(model.init_cache, n_slots=n_slots, max_len=max_len)
    want = jax_unified.detect_state_axes(Model.for_config(cfg_jax).init_cache,
                                         n_slots=n_slots, max_len=max_len)
    return got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_detect_state_axes_equals_the_reference_reduced(arch):
    got, want = _axes_pair(get_reduced(arch), jax_get_reduced(arch), 2, 32)
    assert got == want and got


@pytest.mark.parametrize("arch", ARCHS)
def test_detect_state_axes_equals_the_reference_full_width(arch):
    """Full-width templates: only ``meta`` tensors, nothing allocated."""
    got, want = _axes_pair(get_config(arch), jax_get_config(arch), 8, 2048)
    assert got == want and got
    tree = DecoderModel(get_config(arch), "cpu").init_cache(8, 2048, device="meta")
    for path, leaf in unified.iter_leaves(tree):
        slot_ax, tok_ax = got[path]
        assert leaf.shape[slot_ax] == 8
        assert tok_ax is None or leaf.shape[tok_ax] == 2048


def test_detect_state_axes_refuses_what_it_cannot_read():
    def shrinks(n, length, device=None):  # a leaf is gone at a longer cache
        leaves = {"a": torch.empty((n, length), device=device)}
        if length <= 16:
            leaves["b"] = torch.empty((n,), device=device)
        return leaves

    assert unified.detect_state_axes(shrinks, n_slots=2, max_len=4) == {
        "['a']": (0, 1), "['b']": (0, None)}
    with pytest.raises(ValueError, match="cache structure changes"):
        unified.detect_state_axes(shrinks, n_slots=2, max_len=16)
    with pytest.raises(ValueError, match="no unambiguous slot batch axis"):
        unified.detect_state_axes(
            lambda n, length, device=None: {"a": torch.empty((4, length), device=device)},
            n_slots=2, max_len=16)


# -------------------------------------------------------- the engine gate


def _plant_overlap(monkeypatch):
    """The executor's planner returns a plan with two simultaneously live
    tensors on the same bytes."""
    real = executor_mod.plan_graph

    def planted(graph, **kw):
        plan = real(graph, **kw)
        recs = sorted(plan.records, key=lambda r: r.tensor_id)
        a, b = next((a, b) for a in recs for b in recs
                    if a.tensor_id < b.tensor_id and a.overlaps(b))
        return dataclasses.replace(
            plan, offsets={**plan.offsets, b.tensor_id: plan.offsets[a.tensor_id]})

    monkeypatch.setattr(executor_mod, "plan_graph", planted)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_with_startup_lint_serves(arch):
    import numpy as np

    eng = _engine(arch, startup_lint=True)
    eng.submit(np.arange(3, dtype=np.int32), max_new_tokens=4)
    (req,) = eng.run_until_done()
    assert len(req.tokens) == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_startup_lint_refuses_a_planted_overlap(arch, monkeypatch):
    monkeypatch.delenv("REPRO_STARTUP_LINT", raising=False)
    _plant_overlap(monkeypatch)
    with pytest.raises(LintGateError, match="arena-collision"):
        _engine(arch, startup_lint=True)
    # off by default: the same plan is then taken as it is
    assert _engine(arch).memory_report.startup_lint_findings is None


def test_startup_lint_follows_the_environment(monkeypatch):
    """``startup_lint=None`` reads REPRO_STARTUP_LINT, the reference's knob."""
    _plant_overlap(monkeypatch)
    monkeypatch.setenv("REPRO_STARTUP_LINT", "1")
    with pytest.raises(LintGateError):
        _engine("qwen3-0.6b")
    assert _engine("qwen3-0.6b", startup_lint=False).memory_report.startup_lint_s is None
