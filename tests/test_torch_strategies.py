"""The port's copy of the paper's whole planning core against the JAX package's.

Every strategy of both registries (Shared Objects and Offset Calculation,
the prior-work baselines and the extensions, and ``auto``) gives the same
assignment, offsets, total and lower bound in both packages on the
``graph_gen`` corpus, and agrees with the port's own frozen oracle
(``core/reference.py``) and validators (``core/validate.py``). The paper's
table checks (``tests/test_paper_tables.py``) run on the port's six
networks; the plan cache round-trips and hits; the order and fusion
searches give the reference's orders and partitions under the
reference's fusion budget. The copied modules are held to the
reference's source, with only the import paths changed.
"""

import inspect
import re

import pytest

torch = pytest.importorskip("torch")

import graph_gen  # noqa: E402
from repro.core.fusion_search import default_local_budget as jax_fusion_budget  # noqa: E402
from repro.core.fusion_search import fusion_search as jax_fusion_search  # noqa: E402
from repro.core import order_search as jax_order  # noqa: E402
from repro.core import plan_io as jax_plan_io  # noqa: E402
from repro.core import planner as jax_planner  # noqa: E402
from repro.core.records import TensorUsageRecord as JaxRecord  # noqa: E402
from repro.models import convnets as jax_convnets  # noqa: E402
from repro_torch.core import (  # noqa: E402
    baselines,
    dynamic,
    extensions,
    offsets,
    optimal,
    order_search,
    plan_io,
    planner,
    reference,
    shared_objects,
)
from repro_torch.core.fusion_search import (  # noqa: E402
    DEFAULT_LOCAL_BUDGET,
    default_local_budget,
    fusion_search,
)
from repro_torch.core.graph import graph_from_records  # noqa: E402
from repro_torch.core.records import (  # noqa: E402
    TensorUsageRecord,
    make_records,
    naive_consumption,
    offsets_lower_bound,
    shared_objects_lower_bound,
)
from repro_torch.core.validate import check_offsets, check_shared_objects  # noqa: E402
from repro_torch.models.convnets import (  # noqa: E402
    PAPER_NETWORKS,
    PAPER_TABLE1,
    PAPER_TABLE2,
)

MB = 2**20
SEEDS = range(12)
KINDS = sorted(graph_gen.GENERATORS)
SO_STRATEGIES = sorted(planner.SHARED_OBJECT_STRATEGIES) + ["auto"]
OFF_STRATEGIES = sorted(planner.OFFSET_STRATEGIES) + ["auto"]


def _to_port(records):
    return [TensorUsageRecord(r.first_op, r.last_op, r.size, r.tensor_id)
            for r in records]


def _to_jax(records):
    return [JaxRecord(r.first_op, r.last_op, r.size, r.tensor_id) for r in records]


# ----------------------------------------------------------- the sources

# modules copied whole: the reference's source with repro -> repro_torch
COPIED = ["core/shared_objects.py", "core/offsets.py", "core/baselines.py",
          "core/extensions.py", "core/optimal.py", "core/reference.py",
          "core/validate.py", "core/dynamic.py", "core/order_search.py",
          "core/planner.py", "core/records.py", "core/graph.py",
          "models/convnets.py"]


def _ported(text: str) -> str:
    text = re.sub(r"\brepro\.", "repro_torch.", text)
    return re.sub(r"(from|import) repro\b(?!_torch)", r"\1 repro_torch", text)


@pytest.mark.parametrize("path", COPIED)
def test_copied_module_is_the_reference(path):
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "src"
    want = _ported((root / "repro" / path).read_text())
    got = (root / "repro_torch" / path).read_text()
    if path == "core/graph.py":  # the one docstring line naming the tracer
        want = want.replace("* traced JAX programs (``trace/jaxpr_liveness.py``)",
                            "* traced PyTorch programs (``trace/fx_liveness.py``)")
    assert got == want


@pytest.mark.parametrize("name", ["PlanCache", "plan_signature", "plan_to_obj",
                                  "plan_from_obj", "_copy_plan", "default_cache",
                                  "_env_max_disk_bytes", "canonical_records"])
def test_plan_io_is_the_reference_under_its_own_variables(name):
    """The disk tier reads REPRO_TORCH_PLAN_CACHE_DIR / _MAX_BYTES, so the
    two packages never serve each other's cached plans."""
    want = _ported(inspect.getsource(getattr(jax_plan_io, name)))
    want = want.replace("REPRO_PLAN_CACHE", "REPRO_TORCH_PLAN_CACHE")
    assert inspect.getsource(getattr(plan_io, name)) == want


# ------------------------------------------------- strategies vs the JAX one


def _assert_same(recs, mode, strategy):
    want = jax_planner.plan_records(_to_jax(recs), mode=mode, strategy=strategy,
                                    use_cache=False)
    got = planner.plan_records(recs, mode=mode, strategy=strategy, use_cache=False)
    assert got.strategy == want.strategy
    assert got.offsets == want.offsets
    assert got.total_size == want.total_size
    assert got.lower_bound == want.lower_bound
    assert got.naive_size == want.naive_size
    if mode == "shared_objects":
        assert got.shared_objects.assignment == want.shared_objects.assignment
        assert ([o.size for o in got.shared_objects.objects]
                == [o.size for o in want.shared_objects.objects])
    return got


@pytest.mark.parametrize("strategy", SO_STRATEGIES)
@pytest.mark.parametrize("kind", KINDS)
def test_shared_objects_identical_on_the_corpus(kind, strategy):
    for seed in SEEDS:
        recs = _to_port(graph_gen.generate(kind, seed))
        got = _assert_same(recs, "shared_objects", strategy)
        check_shared_objects(recs, got.shared_objects)
        check_offsets(recs, offsets.OffsetAssignment(got.strategy, got.offsets,
                                                     got.total_size))


@pytest.mark.parametrize("strategy", OFF_STRATEGIES)
@pytest.mark.parametrize("kind", KINDS)
def test_offsets_identical_on_the_corpus(kind, strategy):
    for seed in SEEDS:
        recs = _to_port(graph_gen.generate(kind, seed))
        got = _assert_same(recs, "offsets", strategy)
        check_offsets(recs, offsets.OffsetAssignment(got.strategy, got.offsets,
                                                     got.total_size))


@pytest.mark.parametrize("name", sorted(reference.REFERENCE_SHARED_OBJECT_STRATEGIES))
@pytest.mark.parametrize("kind", KINDS)
def test_shared_objects_match_the_frozen_oracle(kind, name):
    for seed in SEEDS:
        recs = _to_port(graph_gen.generate(kind, seed))
        fast = planner.SHARED_OBJECT_STRATEGIES[name](recs)
        ref = reference.REFERENCE_SHARED_OBJECT_STRATEGIES[name](recs)
        assert fast.assignment == ref.assignment
        assert [o.size for o in fast.objects] == [o.size for o in ref.objects]


@pytest.mark.parametrize("name", sorted(reference.REFERENCE_OFFSET_STRATEGIES))
@pytest.mark.parametrize("kind", KINDS)
def test_offsets_match_the_frozen_oracle(kind, name):
    for seed in SEEDS:
        recs = _to_port(graph_gen.generate(kind, seed))
        fast = planner.OFFSET_STRATEGIES[name](recs)
        ref = reference.REFERENCE_OFFSET_STRATEGIES[name](recs)
        assert fast.offsets == ref.offsets
        assert fast.total_size == ref.total_size


@pytest.mark.parametrize("kind", KINDS)
def test_optimal_and_dynamic_match_the_reference(kind):
    from repro.core import dynamic as jax_dynamic
    from repro.core import optimal as jax_optimal

    for seed in range(6):
        jrecs = graph_gen.generate(kind, seed)[:10]  # branch and bound: small
        recs = _to_port(jrecs)
        assert (optimal.optimal_offsets_total(recs)
                == jax_optimal.optimal_offsets_total(jrecs))
        assert (optimal.optimal_shared_objects_total(recs)
                == jax_optimal.optimal_shared_objects_total(jrecs))
    jrecs = graph_gen.generate(kind, 3)
    got, want = dynamic.IncrementalPlanner(), jax_dynamic.IncrementalPlanner()
    half = len(jrecs) // 2
    for part in (slice(0, half), slice(half, None)):
        got.extend(_to_port(jrecs[part]))
        want.extend(jrecs[part])
    assert got.offsets == want.offsets
    assert got.total_size == want.total_size
    assert got.overhead_vs_oneshot() == want.overhead_vs_oneshot()


def test_strategy_registries_are_the_reference_ones():
    assert sorted(planner.SHARED_OBJECT_STRATEGIES) == sorted(
        jax_planner.SHARED_OBJECT_STRATEGIES)
    assert sorted(planner.OFFSET_STRATEGIES) == sorted(jax_planner.OFFSET_STRATEGIES)
    assert planner.AUTO_OFFSET_PORTFOLIO == jax_planner.AUTO_OFFSET_PORTFOLIO
    assert (planner.AUTO_SHARED_OBJECT_PORTFOLIO
            == jax_planner.AUTO_SHARED_OBJECT_PORTFOLIO)


# --------------------------------------------- the paper's tables, on the port

FAITHFUL = ["mobilenet_v1", "mobilenet_v2", "inception_v3"]


@pytest.fixture(scope="module")
def recs():
    return {n: fn().usage_records() for n, fn in PAPER_NETWORKS.items()}


@pytest.mark.parametrize("net", sorted(PAPER_NETWORKS))
def test_networks_are_the_reference_graphs(recs, net):
    want = jax_convnets.PAPER_NETWORKS[net]().usage_records()
    assert [(r.first_op, r.last_op, r.size, r.tensor_id) for r in recs[net]] == [
        (r.first_op, r.last_op, r.size, r.tensor_id) for r in want]


@pytest.mark.parametrize("net", FAITHFUL)
def test_naive_and_lb_match_paper(recs, net):
    naive = naive_consumption(recs[net]) / MB
    assert naive == pytest.approx(PAPER_TABLE1["naive"][net], rel=0.015)
    lb_off = offsets_lower_bound(recs[net]) / MB
    assert lb_off == pytest.approx(PAPER_TABLE2["lower_bound"][net], rel=0.001)
    lb_so = shared_objects_lower_bound(recs[net]) / MB
    assert lb_so == pytest.approx(PAPER_TABLE1["lower_bound"][net], rel=0.01)


@pytest.mark.parametrize("net", FAITHFUL)
def test_offsets_gbs_matches_paper(recs, net):
    got = offsets.greedy_by_size_offsets(recs[net]).total_size / MB
    assert got == pytest.approx(PAPER_TABLE2["greedy_by_size"][net], rel=0.001)


@pytest.mark.parametrize("net", FAITHFUL + ["posenet"])
def test_offsets_gbs_hits_lower_bound(recs, net):
    got = offsets.greedy_by_size_offsets(recs[net]).total_size
    assert got == offsets_lower_bound(recs[net])


@pytest.mark.parametrize("net,mb", [("mobilenet_v1", 6.125), ("mobilenet_v2", 6.508),
                                    ("inception_v3", 10.624)])
def test_prior_work_rows_match_paper(recs, net, mb):
    got = baselines.tflite_greedy_in_order_offsets(recs[net]).total_size / MB
    assert got == pytest.approx(mb, rel=0.001)


@pytest.mark.parametrize("net,mb", [("mobilenet_v1", 5.359), ("mobilenet_v2", 7.513)])
def test_mcf_rows_match_paper(recs, net, mb):
    got = baselines.min_cost_flow_assignment(recs[net]).total_size / MB
    assert got == pytest.approx(mb, rel=0.001)


@pytest.mark.parametrize("net", FAITHFUL)
def test_shared_objects_gbsi_table1(recs, net):
    got = shared_objects.greedy_by_size_improved(recs[net]).total_size / MB
    want = PAPER_TABLE1["greedy_by_size_improved"][net]
    assert got == pytest.approx(want, rel=0.035)


@pytest.mark.parametrize("net", sorted(PAPER_NETWORKS))
def test_qualitative_claims_all_nets(recs, net):
    rs = recs[net]
    gbs_off = offsets.greedy_by_size_offsets(rs).total_size
    assert gbs_off <= 1.10 * offsets_lower_bound(rs)
    assert (shared_objects.greedy_by_size_improved(rs).total_size
            <= shared_objects.greedy_by_size(rs).total_size)
    assert naive_consumption(rs) / gbs_off >= 3.0


@pytest.mark.parametrize("net", sorted(PAPER_NETWORKS))
def test_extensions_never_worse_than_the_paper(recs, net):
    rs = recs[net]
    assert (extensions.offsets_best_of_all(rs).total_size
            <= offsets.greedy_by_size_offsets(rs).total_size)
    check_shared_objects(rs, extensions.greedy_by_conflict(rs))


# ------------------------------------------------------------ the plan cache


@pytest.mark.parametrize("mode", ["offsets", "shared_objects"])
def test_plan_json_round_trips_to_the_reference_document(mode):
    recs = _to_port(graph_gen.generate("layered", 4))
    got = planner.plan_records(recs, mode=mode, strategy="auto", use_cache=False)
    want = jax_planner.plan_records(_to_jax(recs), mode=mode, strategy="auto",
                                    use_cache=False)
    got.plan_wall_s = want.plan_wall_s = 0.0
    text = plan_io.plan_to_json(got)
    assert text == jax_plan_io.plan_to_json(want)
    back = plan_io.plan_from_json(text)
    assert back.offsets == got.offsets and back.total_size == got.total_size
    if mode == "shared_objects":
        assert back.shared_objects.assignment == got.shared_objects.assignment


@pytest.mark.parametrize("mode", ["offsets", "shared_objects"])
def test_a_second_identical_call_is_a_cache_hit(mode):
    cache = plan_io.PlanCache()
    recs = _to_port(graph_gen.generate("chain", 2))
    calls = planner.PLAN_CALLS
    first = planner.plan_records(recs, mode=mode, cache=cache, graph_name="a")
    second = planner.plan_records(recs, mode=mode, cache=cache, graph_name="b")
    assert planner.PLAN_CALLS == calls + 2  # a hit counts, as in the reference
    assert not first.cache_hit and second.cache_hit
    assert second.graph_name == "b" and second.offsets == first.offsets
    assert cache.stats == {"hits": 1, "misses": 1, "entries": 1}
    assert plan_io.plan_signature(recs, mode=mode, strategy="x") == \
        jax_plan_io.plan_signature(_to_jax(recs), mode=mode, strategy="x")


def test_the_disk_tier_reads_the_ports_own_variable(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_PLAN_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("REPRO_TORCH_PLAN_CACHE_DIR", str(tmp_path / "port"))
    recs = _to_port(graph_gen.generate("ties", 1))
    planner.plan_records(recs, strategy="greedy_by_size")
    assert len(list((tmp_path / "port").glob("*.json"))) == 1
    assert not (tmp_path / "jax").exists()
    again = plan_io.PlanCache(tmp_path / "port")
    key = plan_io.plan_signature(recs, mode="offsets", strategy="greedy_by_size")
    assert again.get(key) is not None


# ------------------------------------------------ order and fusion search

NETS = ["mobilenet_v1", "blazeface"]


@pytest.mark.parametrize("net", NETS)
def test_fusion_search_gives_the_reference_partition(net):
    budget = jax_fusion_budget()
    got = fusion_search(PAPER_NETWORKS[net](), local_budget=budget)
    want = jax_fusion_search(jax_convnets.PAPER_NETWORKS[net](),
                                    local_budget=budget)
    assert got.groups == want.groups
    assert got.plan.total_size == want.plan.total_size
    assert got.plan.offsets == want.plan.offsets


@pytest.mark.parametrize("net", NETS)
def test_search_order_gives_the_reference_order(net):
    got = order_search.search_order(PAPER_NETWORKS[net](), iters=150, seed=0)
    want = jax_order.search_order(jax_convnets.PAPER_NETWORKS[net](), iters=150, seed=0)
    assert got.order == want.order
    assert got.plan.total_size == want.plan.total_size


@pytest.mark.parametrize("seed", range(4))
def test_searches_agree_on_random_graphs(seed):
    import random

    from repro.core.graph import graph_from_records as jax_graph_from_records
    from repro.core.records import make_records as jax_make_records

    rng = random.Random(seed)
    triples = []
    for _ in range(24):
        a = rng.randrange(12)
        triples.append((a, rng.randrange(a, 12), 64 * rng.randrange(1, 16)))
    g = graph_from_records(make_records(triples), name="g")
    jg = jax_graph_from_records(jax_make_records(triples), name="g")
    assert (order_search.memory_aware_order(g) == jax_order.memory_aware_order(jg))
    got = fusion_search(g, local_budget=4096)
    want = jax_fusion_search(jg, local_budget=4096)
    assert got.groups == want.groups and got.plan.total_size == want.plan.total_size


def test_fusion_default_budget_is_the_hopper_model():
    from repro_torch.kernels import smem_plan

    assert default_local_budget() == smem_plan.fusion_scratch_budget()
    assert DEFAULT_LOCAL_BUDGET == smem_plan.fusion_scratch_budget()
