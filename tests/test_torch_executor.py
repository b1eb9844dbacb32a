"""The port's ``ArenaExecutor`` against eager execution and the reference.

Twin of ``tests/test_trace_and_executor.py``. Reduced qwen3 and mamba2 in
float32, the reference's params bridged through numpy: the decode step
run by the executor (every intermediate at its planned arena offset)
must give the eager step's logits and cache bytes bit for bit, and the
reference's within ``test_torch_model.py``'s tolerances (logits 1e-4,
caches 1e-5). The reduced mamba2 prefill through the executor must equal
the eager prefill bit for bit, and the reference's within
``test_torch_ssm.py``'s 1e-4.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.core import plan_io as jax_plan_io  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro_torch.bridge import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core import plan_io, planner  # noqa: E402
from repro_torch.core.planner import plan_graph  # noqa: E402
from repro_torch.models.api import DecoderModel  # noqa: E402
from repro_torch.runtime.arena import Arena, ArenaLayout  # noqa: E402
from repro_torch.runtime.executor import ArenaExecutor, out_overload  # noqa: E402
from repro_torch.trace import fx_liveness  # noqa: E402

ARCHS = ["qwen3-0.6b", "mamba2-2.7b"]
B, T = 3, 16
# active masks of successive steps: rows drop out and come back
MASKS = [[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 1]]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
    jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_numpy(cfg, _np_tree(jparams), "cpu")


def _decode_executor(model, params, caches, **kw):
    def decode(p, f, t, c, pos, a):
        return model.decode_step(p, t, c, pos, a, rope_freqs=f)

    n = _leaves(caches)[0].shape[1]  # slots: axis 1 of a period leaf
    return ArenaExecutor(
        decode, params, model.rope_freqs, torch.zeros((n, 1), dtype=torch.int32),
        caches, torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool),
        **kw,
    )


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_executor_decode_equals_eager_and_the_reference(setup):
    jcfg, cfg, jparams, params = setup
    jmodel, model = Model.for_config(jcfg), DecoderModel(cfg, "cpu")
    jcache = jmodel.init_cache(B, T)
    c_exec = cache_from_numpy(cfg, _np_tree(jcache), "cpu")
    c_eager = cache_from_numpy(cfg, _np_tree(jcache), "cpu")
    ex = _decode_executor(model, params, c_exec)
    decode = jax.jit(lambda p, t, c, pos, a: jmodel.decode_step(p, t, c, pos, active=a))
    rng = np.random.default_rng(4)
    pos = np.zeros(B, np.int32)
    for mask in MASKS:
        tok = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
        active = np.array(mask, bool)
        args = (torch.from_numpy(tok), torch.from_numpy(pos), torch.from_numpy(active))
        got, out_caches = ex(params, model.rope_freqs, args[0], c_exec, *args[1:])
        want, _ = model.decode_step(params, args[0], c_eager, *args[1:])
        lj, jcache = decode(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos),
                            jnp.asarray(active))
        assert torch.equal(got, want)
        assert all(a is b for a, b in zip(_leaves(out_caches), _leaves(c_exec)))
        for g, w, j in zip(_leaves(c_exec), _leaves(c_eager), jax.tree_util.tree_leaves(jcache)):
            assert torch.equal(g, w)
            _close(g, j, 1e-5)
        _close(got, lj, 1e-4)
        pos = pos + active.astype(np.int32)


@pytest.mark.parametrize("S", [100, 600])
def test_executor_prefill_equals_eager_and_the_reference(S):
    """Reduced mamba2 prefill: one chunk, and three (the last padded),
    where each ``ssd_chunk`` node is copied into the arena."""
    jcfg, cfg = jax_get_reduced("mamba2-2.7b"), get_reduced("mamba2-2.7b")
    jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, _np_tree(jparams), "cpu")
    model = DecoderModel(cfg, "cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (1, S)).astype(np.int32)
    tt = torch.from_numpy(tokens)
    ex = ArenaExecutor(lambda p, t: model.prefill(p, {"tokens": t}), params, tt)
    got_logits, got_caches = ex(params, tt)
    want_logits, want_caches = model.prefill(params, {"tokens": tt})
    lj, cj = Model.for_config(jcfg).prefill(jparams, {"tokens": jnp.asarray(tokens)})
    assert torch.equal(got_logits, want_logits)
    for g, w, j in zip(_leaves(got_caches), _leaves(want_caches),
                       jax.tree_util.tree_leaves(cj)):
        assert torch.equal(g, w)
        _close(g, j, 1e-4)
    _close(got_logits, lj, 1e-4)
    n_chunks = -(-S // 256)
    copied = [n for n in ex.trace.produced
              if str(n.target) == "repro_torch.ssd_chunk.default"]
    assert len(copied) == n_chunks * cfg.n_layers
    assert ex.stats.n_copied == len(copied)


def test_arena_is_smaller_than_naive_and_never_moves(setup):
    _, cfg, _, params = setup
    model = DecoderModel(cfg, "cpu")
    caches = model.init_cache(B, T)
    ex = _decode_executor(model, params, caches)
    assert ex.stats.arena_bytes < ex.stats.naive_peak_bytes
    assert ex.stats.reduction > 1.0
    assert ex.arena.nbytes == max(ex.plan.total_size, 1)
    ptr = ex.arena.buf.data_ptr()
    rng = np.random.default_rng(6)
    for step in range(8):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32))
        ex(params, model.rope_freqs, tok, caches, torch.full((B,), step, dtype=torch.int32),
           torch.ones(B, dtype=torch.bool))
        assert ex.arena.buf.data_ptr() == ptr


def test_stats_add_up_to_the_producing_nodes(setup):
    _, cfg, _, params = setup
    model = DecoderModel(cfg, "cpu")
    ex = _decode_executor(model, params, model.init_cache(B, T))
    st = ex.stats
    produced = ex.trace.produced
    assert st.n_in_place + st.n_copied + st.n_boundary == len(produced)
    assert st.n_ops == len(ex.graph.ops)
    custom = [n for n in produced if str(n.target).startswith("repro_torch.")]
    # every aten producer of the decode step has an out= overload; the
    # custom op has none and is copied
    assert st.n_copied == len(custom)
    assert st.copied_bytes == sum(n.meta["val"].numel() * 4 for n in custom)
    if cfg.family == "dense":
        assert len(custom) == cfg.n_layers
    # the logits are the step's one boundary result
    assert st.n_boundary == 1


def test_boundary_tensors_stay_out_of_the_arena(setup):
    _, cfg, _, params = setup
    model = DecoderModel(cfg, "cpu")
    caches = model.init_cache(B, T)
    ex = _decode_executor(model, params, caches)
    logits, out = ex(params, model.rope_freqs, torch.zeros((B, 1), dtype=torch.int32),
                     caches, torch.zeros(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool))
    lo = ex.arena.buf.data_ptr()
    hi = lo + ex.arena.nbytes
    assert not lo <= logits.data_ptr() < hi
    for leaf in _leaves(out):
        assert not lo <= leaf.data_ptr() < hi
    for tid in ex.graph.boundary_ids:
        assert tid not in ex.plan.offsets


def test_a_precomputed_plan_is_checked(setup):
    _, cfg, _, params = setup
    model = DecoderModel(cfg, "cpu")
    caches = model.init_cache(B, T)
    good = _decode_executor(model, params, caches)
    before = planner.PLAN_CALLS
    again = _decode_executor(model, params, caches, plan=good.plan)
    assert planner.PLAN_CALLS == before  # the planner did not run
    assert again.plan is good.plan
    stale = model.init_cache(B + 1, T)  # another batch: other records
    with pytest.raises(ValueError, match="does not match"):
        _decode_executor(model, params, stale, plan=good.plan)


def test_canonical_records_is_the_reference_copy():
    assert inspect.getsource(plan_io.canonical_records) == inspect.getsource(
        jax_plan_io.canonical_records)


def test_a_strided_view_past_its_slot_raises():
    layout = ArenaLayout(total_size=256, offsets={0: 0, 1: 128}, sizes={0: 128, 1: 128})
    arena = Arena(layout, "cpu")
    view = arena.strided_view(0, (4, 8), (1, 4), torch.float32)  # permuted, 128 B
    assert view.stride() == (1, 4) and view.data_ptr() == arena.buf.data_ptr()
    view.copy_(torch.arange(32.0).reshape(4, 8))
    assert torch.equal(arena.buf[:128].view(torch.float32).reshape(8, 4).T,
                       torch.arange(32.0).reshape(4, 8))
    with pytest.raises(ValueError, match="exceeds planned"):
        arena.strided_view(0, (4, 8), (1, 5), torch.float32)  # 37 elements
    with pytest.raises(ValueError, match="exceeds planned"):
        arena.strided_view(1, (33,), (1,), torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_traced_values_are_dense(arch):
    """No producing node of the ported decode step or prefill has gaps
    between its elements: each is sized by ``prod(shape) × itemsize``."""
    cfg = get_reduced(arch)
    model = DecoderModel(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    traces = [_decode_executor(model, params, model.init_cache(B, T)).trace]
    if cfg.family == "ssm":
        traces.append(fx_liveness.trace_fx(
            lambda p, t: model.prefill(p, {"tokens": t}), params,
            torch.zeros((1, 300), dtype=torch.int64)))
    for tr in traces:
        for node, tids in tr.produced.items():
            val = node.meta["val"]
            for v in val if isinstance(val, (tuple, list)) else (val,):
                assert fx_liveness.extent(v) == v.numel(), node


def test_out_overloads_are_resolved_from_the_schema():
    aten = torch.ops.aten
    assert out_overload(aten.mm.default)[0] is aten.mm.out
    assert out_overload(aten.mul.Scalar)[0] is aten.mul.Scalar_out
    assert out_overload(aten.where.self)[0] is aten.where.self_out
    op, names, dropped = out_overload(aten.arange.default)
    assert op is aten.arange.out and names == ("out",)
    assert dropped == {"dtype", "layout", "device", "pin_memory"}
    assert out_overload(aten.topk.default)[1] == ("values", "indices")
    assert out_overload(torch.ops.repro_torch.flash_decode.default) is None


def test_an_op_that_cannot_be_placed_raises_at_construction():
    def fn(x):
        return (x * 2).to("meta") + 1  # an intermediate on another device

    with pytest.raises(ValueError, match="_to_copy"):
        ArenaExecutor(fn, torch.ones(4))


def test_the_trace_keeps_the_graph_and_the_node_map():
    cfg = get_reduced("qwen3-0.6b")
    model = DecoderModel(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    before = fx_liveness.TRACE_CALLS
    ex = _decode_executor(model, params, model.init_cache(B, T))
    assert fx_liveness.TRACE_CALLS == before + 1
    tr = ex.trace
    ops = [n for n in tr.gm.graph.nodes if n.op == "call_function"]
    assert len(ops) == len(tr.graph.ops)
    for node, tids in tr.produced.items():
        assert all(t in tr.graph.tensors for t in tids)
        assert tr.node_tid[node] in (tids[0], tids)
    assert plan_graph(tr.graph).total_size == ex.plan.total_size


def test_an_executor_with_no_tensor_and_no_device_is_on_the_card():
    """Example arguments that hold no tensor give the arena no device: it
    is then the card, and without one a RuntimeError; ``device="cpu"``
    asks for the CPU."""

    def fn(n):
        return torch.arange(n, dtype=torch.float32) * 2.0

    ex = ArenaExecutor(fn, 4, device="cpu")
    assert ex.device.type == "cpu"
    assert torch.equal(ex(4), fn(4))
    if torch.cuda.is_available():
        assert ArenaExecutor(fn, 4).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ArenaExecutor(fn, 4)
