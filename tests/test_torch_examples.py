"""The port's examples (``repro_torch.examples``) against the reference's
``examples/`` and the planner functions behind its Tables 1-2.

Quickstart: the MobileNet v1 line, ``my_model``'s planned arena and its
output on seeded inputs are the reference's. dynamic_shapes prints the
reference's four lines. Tables 1-2: every entry equals what the
reference's strategies give on the reference's networks, the searched
row equals the reference's search at its 12 MiB budget, every claim
passes, and at the port's own budget the search shrinks nothing, as the
reference's does at that budget. serve_lm on reduced mamba2-2.7b: the slot log, the counts, the
state's planned bytes and the slot audit line are the reference CLI's
(the tokens are not: the weights come from different generators), and a
planted overlap makes the audit raise. train_lm: the loss falls.
"""

import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core import offsets as jax_offsets  # noqa: E402
from repro.core import shared_objects as jax_shared_objects  # noqa: E402
from repro.core.fusion_search import default_local_budget as jax_fusion_budget  # noqa: E402
from repro.core.fusion_search import fusion_search as jax_fusion_search  # noqa: E402
from repro.core.order_search import search_order as jax_search_order  # noqa: E402
from repro.core.plan_io import PlanCache as JaxPlanCache  # noqa: E402
from repro.core.planner import plan_graph as jax_plan_graph  # noqa: E402
from repro.core.records import naive_consumption as jax_naive  # noqa: E402
from repro.core.records import offsets_lower_bound as jax_offsets_lb  # noqa: E402
from repro.core.records import shared_objects_lower_bound as jax_so_lb  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import convnets as jax_convnets  # noqa: E402
from repro.trace.jaxpr_liveness import trace_graph as jax_trace_graph  # noqa: E402
from repro_torch.core.fusion_search import fusion_search  # noqa: E402
from repro_torch.core.fusion_search import default_local_budget  # noqa: E402
from repro_torch.core.order_search import search_order  # noqa: E402
from repro_torch.core.plan_io import PlanCache  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    dynamic_shapes,
    paper_tables,
    quickstart,
    serve_lm,
    train_lm,
)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convnets import PAPER_NETWORKS  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MB = 2**20


# ------------------------------------------------------------ quickstart

def test_quickstart_prints_the_references_plans_and_computes_its_function(capsys):
    got = quickstart.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()

    want = jax_plan_graph(jax_convnets.mobilenet_v1(), mode="offsets",
                          strategy="greedy_by_size")
    assert lines[0] == f"MobileNet v1: {want.summary()}"
    assert got["mobilenet_total_bytes"] == want.total_size

    # the same inputs through the reference's JAX function
    reference = runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    rng = np.random.default_rng(0)
    inputs = [quickstart.make_input(rng, s) for s in quickstart.SHAPES]
    jargs = [jnp.asarray(a) for a in inputs]
    jplan = jax_plan_graph(jax_trace_graph(reference["my_model"], *jargs))
    assert got["plan_total_bytes"] == got["arena_bytes"] == jplan.total_size
    # aten's _softmax is one node where the jaxpr has several (docstring)
    assert got["plan_naive_bytes"] < jplan.naive_size
    np.testing.assert_allclose(got["output"].numpy(),
                               np.asarray(reference["my_model"](*jargs)), rtol=1e-5)
    assert lines[-1].startswith("arena executor: 0.125 MiB arena vs ")
    assert lines[-1].endswith("outputs match eager")


def test_quickstart_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])


# -------------------------------------------------------- dynamic shapes

def test_dynamic_shapes_prints_the_references_lines(capsys):
    runpy.run_path(str(ROOT / "examples" / "dynamic_shapes.py"), run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    got = dynamic_shapes.main()
    assert capsys.readouterr().out.splitlines() == want
    assert len(want) == 4
    assert got["stage_bytes"][-1] == 6 * MB


# ----------------------------------------------------------- Tables 1-2

JAX_T1 = {
    "greedy_by_size": jax_shared_objects.greedy_by_size,
    "greedy_by_size_improved": jax_shared_objects.greedy_by_size_improved,
    "greedy_by_breadth": jax_shared_objects.greedy_by_breadth,
    "tflite_greedy (Lee'19)": jax_baselines.tflite_greedy_in_order,
    "min_cost_flow (Lee'19)": jax_baselines.min_cost_flow_assignment,
}
JAX_T2 = {
    "greedy_by_size": jax_offsets.greedy_by_size_offsets,
    "greedy_by_breadth": jax_offsets.greedy_by_breadth_offsets,
    "tflite_greedy (Lee'19)": jax_baselines.tflite_greedy_in_order_offsets,
    "strip_packing (Sekiyama'18)": jax_baselines.strip_packing_bestfit,
}
NETS = list(jax_convnets.PAPER_NETWORKS)


@pytest.fixture(scope="module")
def tables():
    lines: list[str] = []
    got = paper_tables.main(emit=lines.append)
    return got, lines


@pytest.fixture(scope="module")
def reference_searches():
    """The reference's order and fusion searches on its own networks, at
    its default budget and at the port's, through one plan cache as the
    tables plan theirs."""
    cache = JaxPlanCache()
    out = {}
    for net in NETS:
        g = jax_convnets.PAPER_NETWORKS[net]()
        order = jax_search_order(g, iters=300, seed=0, cache=cache).plan.total_size
        out[net] = {
            budget: min(order, jax_fusion_search(g, local_budget=budget,
                                                 cache=cache).plan.total_size) / MB
            for budget in (jax_fusion_budget(), default_local_budget())
        }
    return out


@pytest.mark.parametrize("net", NETS)
def test_table1_is_the_references(tables, net):
    got = tables[0]["table1"][net]
    recs = jax_convnets.PAPER_NETWORKS[net]().usage_records()
    assert set(got) == set(JAX_T1) | {"lower_bound", "naive"}
    for name, fn in JAX_T1.items():
        assert got[name] == pytest.approx(fn(recs).total_size / MB, abs=1e-9), name
    assert got["lower_bound"] == pytest.approx(jax_so_lb(recs) / MB, abs=1e-9)
    assert got["naive"] == pytest.approx(jax_naive(recs) / MB, abs=1e-9)


@pytest.mark.parametrize("net", NETS)
def test_table2_is_the_references(tables, reference_searches, net):
    got = tables[0]["table2"][net]
    recs = jax_convnets.PAPER_NETWORKS[net]().usage_records()
    for name, fn in JAX_T2.items():
        assert got[name] == pytest.approx(fn(recs).total_size / MB, abs=1e-9), name
    assert got["lower_bound"] == pytest.approx(jax_offsets_lb(recs) / MB, abs=1e-9)
    assert got["naive"] == pytest.approx(jax_naive(recs) / MB, abs=1e-9)
    # the claimed row, at the reference's budget
    assert paper_tables.REFERENCE_FUSION_BUDGET == jax_fusion_budget()
    searched = reference_searches[net]
    assert got["searched_order"] == pytest.approx(searched[jax_fusion_budget()], abs=1e-9)


@pytest.mark.parametrize("net", NETS)
def test_the_search_at_the_ports_budget_shrinks_nothing(tables, reference_searches, net):
    """At the port's default fusion budget (one H100 CTA's shared memory
    less its reserve) no tensor of the six networks fits: the search gives
    the fixed-order plan, as the reference's does at that budget, so the
    "strictly improves >= 3 of 6" claim holds only at the reference's
    12 MiB TPU budget (an open question of the port's budget model)."""
    g, cache = PAPER_NETWORKS[net](), PlanCache()
    order = search_order(g, iters=300, seed=0, cache=cache).plan.total_size
    searched = min(order, fusion_search(g, cache=cache).plan.total_size) / MB
    assert searched == pytest.approx(reference_searches[net][default_local_budget()],
                                     abs=1e-9)
    assert searched == pytest.approx(tables[0]["table2"][net]["fixed_order_auto"],
                                     abs=1e-9)


def test_every_paper_claim_passes(tables):
    got, lines = tables
    assert got["failures"] == []
    claims = [ln for ln in lines if ln.startswith(("PASS ", "FAIL "))]
    assert claims and all(ln.startswith("PASS ") for ln in claims)
    assert ("PASS searched order/fusion strictly improves 5/6 nets (need >= 3) at the "
            "reference's 12 MiB TPU fusion budget") in claims
    # the reference's CSV header before each table, one row per entry
    assert lines.count(paper_tables.HEADER) == 2
    rows = [ln for ln in lines if ln.startswith(("table1,", "table2,"))]
    assert len(rows) == 6 * 7 + 6 * 7


# -------------------------------------------------------------- serve_lm

SERVE_ARGV = ["--arch", "mamba2-2.7b"]


def _line(text: str, prefix: str) -> str:
    return next(ln for ln in text.splitlines() if ln.startswith(prefix))


@pytest.fixture(scope="module")
def served():
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        want = jax_serve.run(SERVE_ARGV)
    want_text = out.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = serve_lm.main(SERVE_ARGV + ["--device", "cpu"])
    return got, out.getvalue(), want, want_text


def test_serve_lm_slot_log_and_audit_are_the_references(served):
    got, text, want, want_text = served
    assert got["slot_log"] == [tuple(e) for e in want["slot_log"]]
    for key in ("requests", "tokens", "waves", "host_syncs", "state_planned_bytes"):
        assert got[key] == want[key], key
    assert _line(text, "slot audit:") == _line(want_text, "slot audit:")
    assert _line(text, "slot audit:") == (
        "slot audit: 8 requests over 4 slots, no interval overlap")
    engine = got["engine"]
    live = _line(text, "--- live device state:")
    assert (f"unified plan {engine.unified_plan.total_size} B, residency on"
            in live)


def test_serve_audit_raises_on_an_overlapping_slot_log(monkeypatch):
    audit = serve.from_slot_log

    def planted(slot_log, **kw):
        first = slot_log[0]
        # a second request on the first one's slot while it is live
        return audit([*slot_log, (first[0], first[1], first[2], 99)], **kw)

    monkeypatch.setattr(serve, "from_slot_log", planted)
    with pytest.raises(ValueError, match="overlaps an earlier request"):
        serve.run(["--arch", "mamba2-2.7b", "--device", "cpu", "--requests", "2",
                   "--max-new", "2"])


# -------------------------------------------------------------- train_lm

def test_train_lm_loss_falls_on_the_cpu():
    hist = train_lm.main(["--arch", "qwen3-0.6b", "--steps", "30", "--device", "cpu"])
    assert len(hist) == 30
    assert hist[-1]["loss"] < hist[0]["loss"]
