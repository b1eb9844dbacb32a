"""The port's Mamba2 path against ``repro.models`` and ``repro.runtime``.

Reduced mamba2-2.7b (d_model 256, d_state 16, head_dim 32, 16 heads,
float32), params made by the reference's ``init_params`` and bridged
through numpy; inputs from a numpy seed:

* ``mamba_prefill`` (chunked SSD through ``repro_torch::ssd_chunk``, whose
  CPU path is the plain version) against the reference's ``lax.scan``:
  padding, S < conv - 1, two chunks; also with a slow decay, where the
  state carried between chunks is large;
* ``mamba_decode`` over 6 steps with an ``active`` mask, on caches that
  are views into a state buffer: inactive rows bit-unchanged;
* the model's ``prefill``, ``forward`` and ``decode_step``, and the
  port's own prefill-then-decode against its forward;
* ``InferenceEngine`` against the JAX engine, ``StatePlan`` against the
  reference's, and the traced, planned prefill.

Tolerances: 1e-4 for activations and logits (fp32 matmul and summation
order over a layer), 1e-5 for the decode caches, 2e-4 for the cached
versus uncached logits (the bar of ``tests/test_arch_smoke.py``).
"""

import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.offsets import OffsetAssignment as JaxOffsetAssignment  # noqa: E402
from repro.core.records import TensorUsageRecord as JaxRecord  # noqa: E402
from repro.core.unified import plan_state as jax_plan_state  # noqa: E402
from repro.core.unified import state_records_from_pytree  # noqa: E402
from repro.core.validate import check_offsets  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro.runtime import engine as jax_engine_mod  # noqa: E402
from repro_torch.bridge import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_config, get_reduced  # noqa: E402
from repro_torch.core.unified import plan_state, state_records_from_cache  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.launch import compile as compile_mod  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ssm, transformer  # noqa: E402
from repro_torch.models.api import DecoderModel  # noqa: E402
from repro_torch.runtime import engine as engine_mod  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402
from repro_torch.runtime.residency import StateResidency  # noqa: E402
from repro_torch.trace.fx_liveness import trace_graph  # noqa: E402

ARCH = "mamba2-2.7b"
PROMPT_LENS = (1, 9, 4, 6, 2)
MAX_NEW = (5, 3, 7, 2, 6)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_numpy(cfg, _np_tree(jparams), "cpu")


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def _ssm_kwargs(cfg):
    return dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                ngroups=cfg.ssm_groups, dstate=cfg.ssm_state, conv=cfg.ssm_conv)


def _layer0(jparams, decay):
    """Layer 0's mamba params as numpy; ``"slow"`` sets A in [-0.02,
    -0.001] so that exp(dt·A) stays near 1 and the carried state counts."""
    p = {k: np.array(v[0]) for k, v in jparams["period"][0]["mamba"].items()}
    if decay == "slow":
        p["A_log"] = np.log(np.linspace(0.001, 0.02, p["A_log"].shape[0])).astype(np.float32)
    return p


def test_mamba2_is_ported_and_reduced_as_the_reference():
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    red = get_reduced(ARCH)
    assert (red.d_model, red.ssm_state, red.ssm_head_dim, red.n_layers, red.dtype) == (
        256, 16, 32, 1, "float32")
    assert ssm.ssm_dims(red.d_model, red.ssm_expand, red.ssm_head_dim,
                        red.ssm_groups, red.ssm_state)[1] == 16


@pytest.mark.parametrize("decay", ["original", "slow"])
@pytest.mark.parametrize("S,chunk", [(40, 16), (2, 16), (300, 256)])
def test_mamba_prefill_matches_reference(setup, S, chunk, decay):
    _, cfg, jparams, _ = setup
    p = _layer0(jparams, decay)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model), np.float32)
    out_j, (conv_j, state_j) = jax_ssm.mamba_prefill(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), chunk=chunk,
        **_ssm_kwargs(cfg))
    launches = sc.LAUNCHES
    out_t, (conv_t, state_t) = ssm.mamba_prefill(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        chunk=chunk, **_ssm_kwargs(cfg))
    assert sc.LAUNCHES == launches  # the CPU path never counts a launch
    assert conv_t.shape == (2, cfg.ssm_conv - 1, conv_j.shape[-1])
    _close(out_t, out_j, 1e-4)
    _close(conv_t, conv_j, 1e-4)
    _close(state_t, state_j, 1e-4)
    if decay == "slow" and S > chunk:
        # the carried state is far above the tolerance
        assert float(np.abs(np.asarray(state_j)).max()) > 1e-1


def test_mamba_prefill_calls_the_op_once_per_chunk(setup, monkeypatch):
    _, cfg, jparams, _ = setup
    p = {k: torch.from_numpy(v) for k, v in _layer0(jparams, "original").items()}
    calls = []

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return sc.ssd_chunk(*args)

    monkeypatch.setitem(ssm.SSD, "kernel", spy)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 600, cfg.d_model), np.float32))
    ssm.mamba_prefill(p, x, **_ssm_kwargs(cfg))
    H, P = 16, cfg.ssm_head_dim
    assert calls == [(1, 256, H, P)] * 3  # 600 tokens: 3 chunks, the last padded


def _residency_caches(cfg, n_slots, seed):
    """Caches as views into one state buffer filled with random values."""
    template = transformer.init_cache(cfg, n_slots, 16, "meta")
    plan = plan_state(state_records_from_cache(template, n_slots=n_slots),
                      n_slots=n_slots, max_len=16)
    res = StateResidency(plan, template, n_slots=n_slots)
    buf = res.init_buffer("cpu")
    flat = buf.view(torch.float32)
    flat.copy_(torch.from_numpy(
        np.random.default_rng(seed).standard_normal(flat.numel(), np.float32) * 0.5))
    return res.views(buf)


def test_mamba_decode_matches_reference_in_place(setup):
    _, cfg, jparams, _ = setup
    p = _layer0(jparams, "slow")
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    B = 3
    caches = _residency_caches(cfg, B, 0)
    conv_v, ssm_v = caches["period"][0]["mamba"][0][0], caches["period"][0]["mamba"][1][0]
    assert conv_v.stride(0) == ssm_v.stride(0)  # the plan's slot stride
    jcache = (jnp.asarray(conv_v.numpy()), jnp.asarray(ssm_v.numpy()))
    rng = np.random.default_rng(1)
    masks = [[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 1]]
    for step, mask in enumerate(masks):
        x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
        active = np.array(mask, bool)
        before = (conv_v.clone(), ssm_v.clone())
        out_j, jcache = jax_ssm.mamba_decode(pj, jnp.asarray(x), jcache,
                                             active=jnp.asarray(active),
                                             **_ssm_kwargs(cfg))
        out_t, (conv_t, ssm_t) = ssm.mamba_decode(
            pt, torch.from_numpy(x), (conv_v, ssm_v),
            active=torch.from_numpy(active), **_ssm_kwargs(cfg))
        assert conv_t is conv_v and ssm_t is ssm_v  # written in place
        _close(out_t, out_j, 1e-4)
        _close(conv_v, jcache[0], 1e-5)
        _close(ssm_v, jcache[1], 1e-5)
        off = torch.from_numpy(~active)
        assert torch.equal(conv_v[off], before[0][off]), step
        assert torch.equal(ssm_v[off], before[1][off]), step


def test_decode_step_matches_reference(setup):
    jcfg, cfg, jparams, params = setup
    model = Model.for_config(jcfg)
    B = 3
    jcache = model.init_cache(B, 16)
    cache = cache_from_numpy(cfg, _np_tree(jcache), "cpu")
    decode = jax.jit(lambda p, t, c, pos, a: model.decode_step(p, t, c, pos, active=a))
    rng = np.random.default_rng(4)
    pos = np.zeros(B, np.int32)
    for mask in ([1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]):
        tok = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
        active = np.array(mask, bool)
        lj, jcache = decode(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos),
                            jnp.asarray(active))
        lt, cache = transformer.decode_step(
            params, cfg, torch.from_numpy(tok), cache, torch.from_numpy(pos),
            torch.from_numpy(active))
        _close(lt, lj, 1e-4)
        for got, want in zip(cache["period"][0]["mamba"], jcache["period"][0]["mamba"]):
            _close(got, want, 1e-5)
        pos = pos + active.astype(np.int32)


@pytest.mark.parametrize("n_periods", [1, 2])
def test_prefill_and_forward_match_reference(setup, n_periods):
    jcfg, cfg, jparams, params = setup
    if n_periods != 1:
        jcfg = dataclasses.replace(jcfg, n_periods=n_periods)
        cfg = dataclasses.replace(cfg, n_periods=n_periods)
        jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(1))
        params = params_from_numpy(cfg, _np_tree(jparams), "cpu")
    jmodel, model = Model.for_config(jcfg), DecoderModel(cfg, "cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 300)).astype(np.int32)
    lj, cj = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)})
    lt, ct = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    _close(lt, lj, 1e-4)
    got, want = ct["period"][0]["mamba"], cj["period"][0]["mamba"]
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert got[0].shape[0] == n_periods and ct["remainder"] == ()
    for g, w in zip(got, want):
        _close(g, w, 1e-4)
    fj, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(tokens)})
    ft, aux = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    _close(ft, fj, 1e-4)
    assert float(aux) == 0.0


def test_port_prefill_then_decode_matches_its_forward(setup):
    """decode_step after prefill(t[:n]) reproduces the teacher-forced
    forward logits (the check of tests/test_arch_smoke.py, in the port)."""
    _, cfg, _, params = setup
    model = DecoderModel(cfg, "cpu")
    S, n = 300, 296  # the prefill pads its second chunk
    tokens = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab, (2, S)).astype(np.int32))
    full, _ = model.forward(params, {"tokens": tokens})
    last, caches = model.prefill(params, {"tokens": tokens[:, :n]})
    np.testing.assert_allclose(last.numpy(), full[:, n - 1].numpy(), rtol=2e-4, atol=2e-4)
    for i in range(n, S):
        logits, caches = model.decode_step(
            params, tokens[:, i : i + 1], caches, torch.full((2,), i, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=f"step {i}")


def test_attention_prefill_is_a_later_slice():
    """Attention prefill (ROADMAP A9), once left to a later slice, has
    landed: reduced qwen3 prefills, its caches hold the prompt's K/V, and
    its last logits are forward's (tests/test_torch_window.py holds it
    against the reference)."""
    cfg = get_reduced("qwen3-0.6b")
    model = DecoderModel(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.arange(4, dtype=torch.int32)[None]
    last, caches = model.prefill(params, {"tokens": tokens})
    full, _ = model.forward(params, {"tokens": tokens})
    assert caches["period"][0]["attn"][0].shape == (
        cfg.n_periods, 1, 4, cfg.n_kv_heads, cfg.resolved_head_dim)
    torch.testing.assert_close(last, full[:, -1], rtol=1e-5, atol=1e-5)


def test_reset_slots_zeroes_the_recycled_mamba_state():
    cfg = get_reduced(ARCH)
    caches = _residency_caches(cfg, 3, 2)
    keep = torch.tensor([True, False, True])
    leaves = caches["period"][0]["mamba"]
    kept = [leaf[:, keep].clone() for leaf in leaves]
    transformer.reset_slots(caches, keep)
    for leaf, k in zip(leaves, kept):
        assert torch.equal(leaf[:, keep], k)
        assert not leaf[:, 1].any()


def _serve(engine, mod, prompts):
    for prompt, new in zip(prompts, MAX_NEW):
        engine.submit(prompt, max_new_tokens=new)
    syncs = mod.HOST_SYNCS
    done = engine.run_until_done(raise_on_exhausted=True)
    return {r.request_id: list(r.tokens) for r in done}, mod.HOST_SYNCS - syncs


def test_engine_matches_the_reference_engine(setup):
    """Five requests over two slots, so slots are recycled: a stale SSM
    state would change the next request's tokens."""
    jcfg, cfg, jparams, params = setup
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
    assert len({slot for slot, *_ in eng.slot_log}) < len(prompts)
    assert got_syncs == want_syncs == eng.waves
    rep = eng.memory_report
    assert rep.state_live_bytes == rep.state_plan.total_size
    assert rep.state_live_bytes == jeng.memory_report.state_live_bytes
    assert eng.state.buf.data_ptr() == ptr


@pytest.mark.parametrize(
    "variant,n_slots,max_len", [("reduced", 2, 64), ("full", 8, 2048)]
)
def test_state_plan_equals_the_reference(variant, n_slots, max_len):
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if variant == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    model = Model.for_config(jcfg)
    jax_template = jax.eval_shape(lambda: model.init_cache(n_slots, max_len))
    want = jax_plan_state(state_records_from_pytree(jax_template, n_slots=n_slots),
                          n_slots=n_slots, max_len=max_len)
    template = transformer.init_cache(cfg, n_slots, max_len, "meta")
    got = plan_state(state_records_from_cache(template, n_slots=n_slots),
                     n_slots=n_slots, max_len=max_len)
    assert [(leaf.path, leaf.shape, leaf.dtype, leaf.slot_nbytes, leaf.offset)
            for leaf in got.leaves] == [
        (leaf.path, leaf.shape, leaf.dtype, leaf.slot_nbytes, leaf.offset)
        for leaf in want.leaves
    ]
    assert got.slot_stride == want.slot_stride
    assert got.total_size == want.total_size
    if variant == "full":
        # 64 layers x (3 x 5376 conv + 80 x 64 x 128 SSM) x 2 B x 8 slots
        assert got.total_size >= 64 * (3 * 5376 + 80 * 64 * 128) * 2 * 8


def test_serve_run_on_the_cpu():
    stats = serve.run(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--max-len", "32", "--prompt-len", "4",
                       "--max-new", "3"])
    assert stats["requests"] == 3 and stats["tokens"] == 9
    assert stats["state_ptr_before"] == stats["state_ptr_after"]
    assert stats["state_live_bytes"] == stats["state_planned_bytes"]
    assert stats["last_logits_finite"]


@pytest.mark.parametrize("n_periods,prefill_len", [(1, 600), (2, 300), (2, 40)])
def test_traced_prefill_plan(n_periods, prefill_len):
    """One ssd_chunk node per chunk per layer, each one operator with two
    output tensors; the plan passes the reference's O(n²) checker."""
    cfg = dataclasses.replace(get_reduced(ARCH), n_periods=n_periods)
    graph, plan = compile_mod.plan_prefill(cfg, prefill_len=prefill_len)
    graph.validate()
    ssd_ops = [op for op in graph.ops if op.name == "repro_torch.ssd_chunk.default"]
    n_chunks = -(-prefill_len // min(256, prefill_len))
    assert len(ssd_ops) == n_chunks * n_periods
    for op in ssd_ops:
        assert len(op.outputs) == 2
        y, state = (graph.tensors[t] for t in op.outputs)
        assert y.shape[1] == min(256, prefill_len) and len(state.shape) == 4
    records = [JaxRecord(r.first_op, r.last_op, r.size, r.tensor_id)
               for r in plan.records]
    check_offsets(records, JaxOffsetAssignment(plan.strategy, plan.offsets,
                                               plan.total_size))
    assert plan.lower_bound <= plan.total_size <= plan.naive_size


def test_traced_prefill_is_the_real_prefill_graph(setup):
    """The meta-template trace gives the same operators as a trace of the
    same call on real weights."""
    _, cfg, _, params = setup
    model = DecoderModel(cfg, "cpu")
    real = trace_graph(lambda p, t: model.prefill(p, {"tokens": t}), params,
                       torch.zeros((1, 300), dtype=torch.int64))
    meta = compile_mod.trace_prefill_graph(cfg, prefill_len=300)
    assert collections.Counter(op.name for op in real.ops) == collections.Counter(
        op.name for op in meta.ops)
    assert sorted(r.size for r in real.usage_records()) == sorted(
        r.size for r in meta.usage_records())


def test_bridge_carries_mixed_dtypes():
    """bf16 weights with fp32 A_log, D, dt_bias and norm, as the reference
    makes them, cross into the port leaf for leaf, bits unchanged."""
    jcfg = dataclasses.replace(jax_get_reduced(ARCH), dtype="bfloat16")
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="bfloat16")
    jparams = _np_tree(Model.for_config(jcfg).init(jax.random.PRNGKey(2)))
    params = params_from_numpy(cfg, jparams, "cpu")
    mine = DecoderModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    for key, want in jparams["period"][0]["mamba"].items():
        got = params["period"][0]["mamba"][key]
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, key
        assert got.dtype == mine["period"][0]["mamba"][key].dtype, key
        assert tuple(got.shape) == want.shape == tuple(
            mine["period"][0]["mamba"][key].shape), key
        assert np.array_equal(got.view(torch.uint16).numpy() if got.dtype == torch.bfloat16
                              else got.numpy(),
                              want.view(np.uint16) if want.dtype.name == "bfloat16"
                              else want), key
    assert params["period"][0]["mamba"]["A_log"].dtype == torch.float32
    assert params["period"][0]["mamba"]["in_proj"].dtype == torch.bfloat16


def test_port_decode_continues_the_reference_prefill(setup):
    """The caches the reference's prefill returns, bridged, carry the
    port's decode on exactly as they carry the reference's."""
    jcfg, cfg, jparams, params = setup
    jmodel = Model.for_config(jcfg)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab, (2, 44)).astype(np.int32)
    _, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :40])})
    caches = cache_from_numpy(cfg, _np_tree(jcaches), "cpu")
    decode = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, t, c, pos))
    for i in range(40, 44):
        tok = tokens[:, i : i + 1]
        pos = np.full((2,), i, np.int32)
        lj, jcaches = decode(jparams, jnp.asarray(tok), jcaches, jnp.asarray(pos))
        lt, caches = transformer.decode_step(params, cfg, torch.from_numpy(tok), caches,
                                             torch.from_numpy(pos))
        _close(lt, lj, 1e-4)
        for got, want in zip(caches["period"][0]["mamba"], jcaches["period"][0]["mamba"]):
            _close(got, want, 1e-5)


def test_prefill_caches_do_not_hold_the_layer_activations(setup):
    """The conv cache prefill returns owns its few rows: as a view it kept
    each layer's whole in_proj output alive until the caches were stacked,
    so the planned prefill arena grew by that output per layer."""
    _, cfg, jparams, _ = setup
    p = {k: torch.from_numpy(v) for k, v in _layer0(jparams, "original").items()}
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 300, cfg.d_model), np.float32))
    _, (conv_state, _) = ssm.mamba_prefill(p, x, **_ssm_kwargs(cfg))
    assert conv_state.untyped_storage().nbytes() == conv_state.numel() * 4
    plans = {n: compile_mod.plan_prefill(dataclasses.replace(cfg, n_periods=n),
                                         prefill_len=300)[1] for n in (2, 4)}
    template = transformer.init_cache(cfg, 1, 300, "meta")["period"][0]["mamba"]
    cache_bytes = sum(t.numel() * 4 for t in template)  # per layer
    in_proj_out = 300 * p["in_proj"].shape[-1] * 4
    per_layer = (plans[4].lower_bound - plans[2].lower_bound) / 2
    assert per_layer <= 2 * cache_bytes < in_proj_out
