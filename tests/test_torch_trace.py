"""The fx tracer: the port's decode step as a valid usage-record graph.

The trace's records are not the jaxpr's op for op (the two frameworks
decompose differently), so they are held to the reference's independent
checkers instead: ``Graph.validate`` and the naive O(n²) plan checker
``repro.core.validate.check_offsets``.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core.offsets import OffsetAssignment as JaxOffsetAssignment  # noqa: E402
from repro.core.records import TensorUsageRecord as JaxRecord  # noqa: E402
from repro.core.validate import check_offsets  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core import planner, unified  # noqa: E402
from repro_torch.core.planner import plan_graph  # noqa: E402
from repro_torch.models.api import DecoderModel  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402
from repro_torch.trace import fx_liveness  # noqa: E402

ARCH = "qwen3-0.6b"


@pytest.fixture(scope="module")
def traced():
    cfg = dataclasses.replace(get_reduced(ARCH), n_periods=2)
    model = DecoderModel(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, T = 3, 24
    caches = model.init_cache(B, T)
    graph = fx_liveness.trace_graph(
        lambda p, f, t, c, pos, a: model.decode_step(p, t, c, pos, a, rope_freqs=f),
        params, model.rope_freqs, torch.zeros((B, 1), dtype=torch.int32), caches,
        torch.zeros(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool),
        name="decode",
    )
    return cfg, graph


def test_trace_is_a_valid_graph(traced):
    cfg, graph = traced
    graph.validate()
    names = [op.name for op in graph.ops]
    # the attention kernel traces as ONE op per layer
    assert names.count("repro_torch.flash_decode.default") == cfg.n_layers
    # the in-place K/V writes land on the cache placeholders, which are
    # boundary tensors: no cache-sized intermediate appears
    assert sum(n.startswith("aten.index_put_") for n in names) == 2 * cfg.n_layers
    cache_bytes = 24 * cfg.n_kv_heads * cfg.resolved_head_dim * 3 * 4
    assert all(r.size < cache_bytes for r in graph.usage_records())


@pytest.mark.parametrize(
    "strategy", ["greedy_by_size", "greedy_by_breadth", "strip_packing_bestfit", "auto"]
)
def test_plan_of_the_trace_passes_the_reference_checker(traced, strategy):
    _, graph = traced
    plan = plan_graph(graph, strategy=strategy)
    records = [JaxRecord(r.first_op, r.last_op, r.size, r.tensor_id)
               for r in plan.records]
    check_offsets(
        records, JaxOffsetAssignment(plan.strategy, plan.offsets, plan.total_size)
    )
    assert plan.lower_bound <= plan.total_size <= plan.naive_size


def test_one_trace_one_plan_per_engine_construction():
    cfg = get_reduced(ARCH)
    params = DecoderModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    counts = lambda: (fx_liveness.TRACE_CALLS, planner.PLAN_CALLS,  # noqa: E731
                      unified.STATE_PLAN_CALLS)
    before = counts()
    InferenceEngine(cfg, params, n_slots=2, max_len=32, device="cpu")
    assert [b - a for a, b in zip(before, counts())] == [1, 1, 1]
    InferenceEngine(cfg, params, n_slots=2, max_len=32, device="cpu")
    assert [b - a for a, b in zip(before, counts())] == [2, 2, 2]
