"""The port's copied planner and state layout against the JAX package's.

The port keeps its own copy of the planning core (it imports nothing of
``repro``); these tests hold the copy byte-identical to the reference:
offsets and totals of every strategy of the ``auto`` portfolio on the
``graph_gen`` corpus and on the port's own traced decode records, and
``plan_state`` field for field on the qwen3 cache templates.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import graph_gen  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.core import planner as jax_planner  # noqa: E402
from repro.core.records import TensorUsageRecord as JaxRecord  # noqa: E402
from repro.core.unified import plan_state as jax_plan_state  # noqa: E402
from repro.core.unified import state_records_from_pytree  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.records import TensorUsageRecord  # noqa: E402
from repro_torch.core.unified import plan_state, state_records_from_cache  # noqa: E402
from repro_torch.models.api import DecoderModel  # noqa: E402
from repro_torch.models.transformer import init_cache, init_params  # noqa: E402
from repro_torch.trace.fx_liveness import trace_graph  # noqa: E402

STRATEGIES = ["greedy_by_size", "greedy_by_breadth", "strip_packing_bestfit", "auto"]


def _to_port(records):
    return [TensorUsageRecord(r.first_op, r.last_op, r.size, r.tensor_id)
            for r in records]


def _to_jax(records):
    return [JaxRecord(r.first_op, r.last_op, r.size, r.tensor_id) for r in records]


def _assert_same_plan(jax_records, strategy):
    want = jax_planner.plan_records(jax_records, strategy=strategy, use_cache=False)
    got = planner.plan_records(_to_port(jax_records), strategy=strategy)
    assert got.strategy == want.strategy
    assert got.offsets == want.offsets
    assert got.total_size == want.total_size
    assert got.lower_bound == want.lower_bound
    assert got.naive_size == want.naive_size


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("kind", sorted(graph_gen.GENERATORS))
def test_offsets_identical_on_the_corpus(kind, strategy):
    for seed in range(12):
        _assert_same_plan(graph_gen.generate(kind, seed), strategy)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_offsets_identical_on_a_dense_graph(strategy):
    """Past 1024 overlapping records both arenas switch to the numpy
    gap scan; the copy must agree there too."""
    _assert_same_plan(graph_gen.uniform_records(7, n=1400, max_ops=16), strategy)


@pytest.fixture(scope="module")
def traced_decode_records():
    cfg = dataclasses.replace(get_config("qwen3-0.6b").reduced(), n_periods=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    B, T = 2, 32
    caches = init_cache(cfg, B, T, "cpu")
    model = DecoderModel(cfg, "cpu")
    graph = trace_graph(
        lambda p, f, t, c, pos, a: model.decode_step(p, t, c, pos, a, rope_freqs=f),
        params, model.rope_freqs, torch.zeros((B, 1), dtype=torch.int32), caches,
        torch.zeros(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool),
    )
    return graph.usage_records()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_offsets_identical_on_the_traced_decode_step(traced_decode_records, strategy):
    assert len(traced_decode_records) > 50
    _assert_same_plan(_to_jax(traced_decode_records), strategy)


@pytest.mark.parametrize(
    "variant,n_slots,max_len",
    [("reduced", 2, 64), ("full", 2, 64), ("full", 8, 2048)],
)
def test_state_plan_equals_the_reference(variant, n_slots, max_len):
    jcfg = jax_get_config("qwen3-0.6b")
    cfg = get_config("qwen3-0.6b")
    if variant == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    model = Model.for_config(jcfg)
    jax_template = jax.eval_shape(lambda: model.init_cache(n_slots, max_len))
    want = jax_plan_state(
        state_records_from_pytree(jax_template, n_slots=n_slots),
        n_slots=n_slots, max_len=max_len,
    )
    template = init_cache(cfg, n_slots, max_len, "meta")
    got = plan_state(state_records_from_cache(template, n_slots=n_slots),
                     n_slots=n_slots, max_len=max_len)
    assert [(leaf.path, leaf.shape, leaf.dtype, leaf.slot_nbytes, leaf.offset)
            for leaf in got.leaves] == [
        (leaf.path, leaf.shape, leaf.dtype, leaf.slot_nbytes, leaf.offset)
        for leaf in want.leaves
    ]
    assert got.slot_stride == want.slot_stride
    assert got.total_size == want.total_size
    assert [dataclasses.astuple(v) for v in got.leaf_view_spec()] == [
        dataclasses.astuple(v) for v in want.leaf_view_spec()
    ]
