"""The hybrid family (zamba2-7b): the port against ``repro.models``,
``repro.core.unified`` and ``repro.runtime.engine``.

Float32, reduced zamba2 (a Mamba2 layer and a Mamba2 layer with the
shared attention block: d_model 256, the block at 512 with 4 heads of
128, its own RoPE table beside the layers' 64-wide one), once as the
reference reduces it (one SSM group) and once with ``ssm_groups=2``
(B and C reach the 16 heads through ``repeat_interleave``), the
reference's params bridged through numpy, inputs from numpy seeds:

* ``_apply_shared_attn`` in prefill and decode, ``mamba_prefill`` and
  ``mamba_decode`` at two groups, against the reference's;
* ``forward``, ``prefill`` + ``grow_caches`` + decode, on both cores;
  the engine's tokens, slot log and host syncs against the reference
  engine's;
* ``ArenaExecutor`` runs the decode step and the prefill bit for bit as
  eager, and the traced prefill plan is certified;
* the state records' paths, order and plan, and ``detect_state_axes``,
  equal the reference's (the first cache dict with two keys);
* the shared block reads its own RoPE table, never the layers'.

Tolerances: outputs of one layer 1e-5, logits 1e-4 (fp32 summation
order over a few layers), as in ``test_torch_moe.py``.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.core import unified as jax_unified  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro.runtime import engine as jax_engine_mod  # noqa: E402
from repro_torch.analysis import soundness  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_config, get_reduced  # noqa: E402
from repro_torch.core import unified  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.compile import plan_prefill  # noqa: E402
from repro_torch.models import layers, ssm, transformer  # noqa: E402
from repro_torch.models.api import FAMILIES, DecoderModel  # noqa: E402
from repro_torch.runtime import engine as engine_mod  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402
from repro_torch.runtime.executor import ArenaExecutor  # noqa: E402

ARCH = "zamba2-7b"
GROUPS = (1, 2)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _configs(groups: int):
    jcfg, cfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    if groups != jcfg.ssm_groups:
        jcfg = dataclasses.replace(jcfg, ssm_groups=groups)
        cfg = dataclasses.replace(cfg, ssm_groups=groups)
    return jcfg, cfg


@functools.cache
def _pair(groups: int):
    """(jax cfg, port cfg, jax params, port params) of reduced zamba2 at
    ``groups`` SSM groups (made once per test process; no test writes to
    them)."""
    jcfg, cfg = _configs(groups)
    jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_numpy(cfg, _np_tree(jparams), "cpu")


def _ssm_kwargs(cfg):
    return dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
                ngroups=cfg.ssm_groups, dstate=cfg.ssm_state, conv=cfg.ssm_conv)


# ------------------------------------------------------------- configs


def test_zamba2_is_ported_as_the_reference():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jax_get_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == dataclasses.asdict(
        jax_get_reduced(ARCH))
    assert "hybrid" in FAMILIES
    full = get_config(ARCH)
    assert transformer.shared_head_dim(full) == 224 and full.resolved_head_dim == 112
    red = get_reduced(ARCH)
    assert (transformer.shared_head_dim(red), red.resolved_head_dim) == (128, 64)
    assert sum(s.shared_attn for s in (*full.period * full.n_periods,
                                       *full.remainder)) == 13


@pytest.mark.parametrize("groups", GROUPS)
def test_the_bridged_tree_is_the_references(groups):
    """One shared block, no lead axis: its keys and shapes are the
    reference's and the port's own init's."""
    jcfg, cfg, jparams, params = _pair(groups)
    want = _np_tree(jparams)
    assert set(params["shared_attn"]) == {"ln", "attn", "mlp", "ln2", "out"}
    assert set(params["shared_attn"]["attn"]) == {"wq", "wk", "wv", "wo"}
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g, _ = torch.utils._pytree.tree_flatten_with_path(params)

    def keyed(flat, keystr):
        return {keystr(k): tuple(v.shape) for k, v in flat}

    assert keyed(flat_g, torch.utils._pytree.keystr) == keyed(
        flat_w, jax.tree_util.keystr)
    assert params["shared_attn"]["out"].shape == (2 * cfg.d_model, cfg.d_model)
    mine = DecoderModel(cfg, "meta").init(None)
    assert keyed(torch.utils._pytree.tree_flatten_with_path(mine)[0],
                 torch.utils._pytree.keystr) == keyed(flat_g, torch.utils._pytree.keystr)


# ------------------------------------------------------------- layers


def _shared(groups):
    jcfg, cfg, jparams, params = _pair(groups)
    return (jcfg, cfg, jparams["shared_attn"], params["shared_attn"],
            DecoderModel(cfg, "cpu").shared_freqs)


def test_the_shared_block_prefill_is_the_references():
    jcfg, cfg, sj, st, freqs = _shared(1)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 40, cfg.d_model), np.float32)
    emb0 = rng.standard_normal((2, 40, cfg.d_model), np.float32)
    dj, (kj, vj) = jax_transformer._apply_shared_attn(
        sj, jnp.asarray(h), jnp.asarray(emb0), jcfg, None)
    dt, (kt, vt) = transformer._apply_shared_attn(
        st, torch.from_numpy(h), torch.from_numpy(emb0), cfg, freqs=freqs)
    assert dt.shape == (2, 40, cfg.d_model)
    assert kt.shape == (2, 40, cfg.shared_attn_heads, 128)
    _close(dt, dj, 1e-5)
    _close(kt, kj, 1e-5)
    _close(vt, vj, 1e-5)


@pytest.mark.parametrize("cores", ["kernel", "plain"])
def test_the_shared_block_decode_is_the_references(cores):
    """Six steps at per-slot positions with an ``active`` mask, the cache
    written in place."""
    jcfg, cfg, sj, st, freqs = _shared(1)
    B, T = 3, 12
    H, hd = cfg.shared_attn_heads, transformer.shared_head_dim(cfg)
    rng = np.random.default_rng(4)
    k0 = rng.standard_normal((B, T, H, hd), np.float32) * 0.5
    v0 = rng.standard_normal((B, T, H, hd), np.float32) * 0.5
    jcache = (jnp.asarray(k0), jnp.asarray(v0))
    cache = (torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    pos = np.array([0, 5, 9], np.int32)
    for step in range(6):
        h = rng.standard_normal((B, 1, cfg.d_model), np.float32)
        emb0 = rng.standard_normal((B, 1, cfg.d_model), np.float32)
        active = np.array([True, step % 2 == 0, step != 3])
        dj, jcache = jax_transformer._apply_shared_attn(
            sj, jnp.asarray(h), jnp.asarray(emb0), jcfg, None, jcache,
            jnp.asarray(pos), jnp.asarray(active))
        dt, kv = transformer._apply_shared_attn(
            st, torch.from_numpy(h), torch.from_numpy(emb0), cfg, cache,
            torch.from_numpy(pos), torch.from_numpy(active), freqs, cores)
        assert kv[0] is cache[0] and kv[1] is cache[1]  # written in place
        _close(dt, dj, 1e-5)
        _close(cache[0], jcache[0], 1e-5)
        _close(cache[1], jcache[1], 1e-5)
        pos = pos + active.astype(np.int32)


def _mamba_layer(groups):
    """Layer 0's Mamba2 params as numpy, at a slow decay (A in [-0.02,
    -0.001]) so the state carried between chunks counts."""
    jcfg, cfg, jparams, _ = _pair(groups)
    p = {k: np.array(v[0]) for k, v in jparams["period"][0]["mamba"].items()}
    p["A_log"] = np.log(np.linspace(0.001, 0.02, p["A_log"].shape[0])).astype(np.float32)
    return cfg, p


@pytest.mark.parametrize("S", [40, 300])
def test_two_group_mamba_prefill_is_the_references(S):
    cfg, p = _mamba_layer(2)
    assert cfg.ssm_groups == 2
    x = np.random.default_rng(S).standard_normal((2, S, cfg.d_model), np.float32)
    out_j, (conv_j, state_j) = jax_ssm.mamba_prefill(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), **_ssm_kwargs(cfg))
    out_t, (conv_t, state_t) = ssm.mamba_prefill(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        **_ssm_kwargs(cfg))
    _close(out_t, out_j, 1e-5)
    _close(conv_t, conv_j, 1e-5)
    _close(state_t, state_j, 1e-5)


def test_two_groups_reach_the_heads_group_by_group():
    """Heads 0..7 read group 0's B and C, heads 8..15 group 1's (the
    reference's ``jnp.repeat``), not alternately."""
    t = torch.arange(2 * 3, dtype=torch.float32).reshape(1, 1, 2, 3)
    heads = ssm._heads(t, 16)
    assert torch.equal(heads[0, 0, :8], t[0, 0, 0].expand(8, 3))
    assert torch.equal(heads[0, 0, 8:], t[0, 0, 1].expand(8, 3))
    want = np.repeat(t.numpy(), 8, axis=2)
    np.testing.assert_array_equal(heads.numpy(), want)


def test_two_group_mamba_decode_is_the_references():
    cfg, p = _mamba_layer(2)
    _, nheads, conv_dim = ssm.ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                                       cfg.ssm_groups, cfg.ssm_state)
    B = 3
    rng = np.random.default_rng(5)
    conv0 = rng.standard_normal((B, cfg.ssm_conv - 1, conv_dim), np.float32)
    st0 = rng.standard_normal((B, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                              np.float32) * 0.5
    jcache = (jnp.asarray(conv0), jnp.asarray(st0))
    cache = (torch.from_numpy(conv0.copy()), torch.from_numpy(st0.copy()))
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    for step in range(5):
        x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
        active = np.array([True, step % 2 == 0, True])
        out_j, jcache = jax_ssm.mamba_decode(pj, jnp.asarray(x), jcache,
                                             active=jnp.asarray(active),
                                             **_ssm_kwargs(cfg))
        out_t, cache = ssm.mamba_decode(pt, torch.from_numpy(x), cache,
                                        active=torch.from_numpy(active),
                                        **_ssm_kwargs(cfg))
        _close(out_t, out_j, 1e-5)
        _close(cache[0], jcache[0], 1e-5)
        _close(cache[1], jcache[1], 1e-5)


# ------------------------------------------------------------- model


@pytest.mark.parametrize("cores", ["kernel", "plain"])
@pytest.mark.parametrize("groups", GROUPS)
def test_forward_matches_the_reference(groups, cores):
    jcfg, cfg, jparams, params = _pair(groups)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 300)).astype(np.int32)
    want, _ = Model.for_config(jcfg).forward(jparams, {"tokens": jnp.asarray(tokens)})
    got, aux = DecoderModel(cfg, "cpu", cores=cores).forward(
        params, {"tokens": torch.from_numpy(tokens)})
    _close(got, want, 1e-4)
    assert float(aux) == 0.0


@pytest.mark.parametrize("cores", ["kernel", "plain"])
@pytest.mark.parametrize("groups", GROUPS)
def test_prefill_then_decode_gives_the_references_logits(groups, cores):
    """Prefill 12 tokens, grow the caches to 32 (the shared K/V grows,
    the Mamba2 state keeps its size), decode 4 more."""
    jcfg, cfg, jparams, params = _pair(groups)
    jmodel, model = Model.for_config(jcfg), DecoderModel(cfg, "cpu", cores=cores)
    rng = np.random.default_rng(2)
    S, steps, B = 12, 4, 2
    tokens = rng.integers(0, cfg.vocab, (B, S + steps)).astype(np.int32)
    lj, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    lt, tc = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :S])})
    _close(lt, lj, 1e-4)
    assert list(tc["period"][1]) == ["mamba", "shared"]
    for g, w in zip(_leaves(tc), jax.tree_util.tree_leaves(jc)):
        assert g.shape == w.shape
        _close(g, w, 1e-5)
    jc = jax_transformer.grow_caches(jcfg, jc, 32)
    tc = transformer.grow_caches(cfg, tc, 32)
    assert tc["period"][1]["shared"][0].shape[2] == 32
    for g, w in zip(_leaves(tc), jax.tree_util.tree_leaves(jc)):
        assert g.shape == w.shape
    decode = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, t, c, pos))
    for i in range(S, S + steps):
        pos = np.full(B, i, np.int32)
        lj, jc = decode(jparams, jnp.asarray(tokens[:, i:i + 1]), jc, jnp.asarray(pos))
        lt, tc = model.decode_step(params, torch.from_numpy(tokens[:, i:i + 1]), tc,
                                   torch.from_numpy(pos))
        _close(lt, lj, 1e-4)
    for g, w in zip(_leaves(tc), jax.tree_util.tree_leaves(jc)):
        _close(g, w, 1e-5)


def test_reset_slots_zeroes_the_shared_cache_and_the_mamba_state():
    _, cfg, _, _ = _pair(1)
    model = DecoderModel(cfg, "cpu")
    caches = model.init_cache(3, 8)
    for leaf in _leaves(caches):
        leaf.fill_(1.0)
    model.reset_slots(caches, torch.tensor([True, False, True]))
    for leaf in _leaves(caches):
        assert bool((leaf[:, 1] == 0).all()) and bool((leaf[:, 0] == 1).all())


PROMPT_LENS = (12, 20, 12, 20)
MAX_NEW = (6, 4, 9, 5)


def _serve(engine, mod, prompts):
    for prompt, new in zip(prompts, MAX_NEW):
        engine.submit(prompt, max_new_tokens=new)
    syncs = mod.HOST_SYNCS
    done = engine.run_until_done(raise_on_exhausted=True)
    return {r.request_id: list(r.tokens) for r in done}, mod.HOST_SYNCS - syncs


@pytest.mark.parametrize("groups", GROUPS)
def test_engine_matches_the_reference_engine(groups):
    jcfg, cfg, jparams, params = _pair(groups)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in PROMPT_LENS]
    jeng = jax_engine_mod.InferenceEngine(jcfg, jparams, n_slots=2, max_len=64)
    want, want_syncs = _serve(jeng, jax_engine_mod, prompts)
    eng = InferenceEngine(cfg, params, n_slots=2, max_len=64, device="cpu")
    ptr = eng.state.buf.data_ptr()
    got, got_syncs = _serve(eng, engine_mod, prompts)
    assert got == want
    assert eng.slot_log == jeng.slot_log
    assert got_syncs == want_syncs == eng.waves
    rep = eng.memory_report
    assert rep.state_live_bytes == rep.state_plan.total_size
    assert rep.state_live_bytes == jeng.memory_report.state_live_bytes
    assert eng.state.buf.data_ptr() == ptr
    # both kinds of state in the one buffer: the shared K/V and the
    # Mamba2 conv windows and states
    kinds = {leaf.path.split("'")[-2] for leaf in rep.state_plan.leaves}
    assert kinds == {"mamba", "shared"}


# ------------------------------------------------------------- state


@pytest.mark.parametrize("variant,n_slots,max_len",
                         [("reduced", 2, 64), ("two_groups", 3, 48), ("full", 8, 2048)])
def test_state_records_and_plan_are_the_references(variant, n_slots, max_len):
    """Paths and order of the records ("mamba" before "shared", as JAX
    sorts dict keys), and the plan laid out from them."""
    if variant == "full":
        jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    else:
        jcfg, cfg = _configs(2 if variant == "two_groups" else 1)
    model = Model.for_config(jcfg)
    jtemplate = jax.eval_shape(lambda: model.init_cache(n_slots, max_len))
    want = jax_unified.state_records_from_pytree(jtemplate, n_slots=n_slots)
    template = transformer.init_cache(cfg, n_slots, max_len, "meta")
    got = unified.state_records_from_cache(template, n_slots=n_slots)
    assert [(r.path, r.shape, r.dtype, r.nbytes) for r in got] == [
        (r.path, r.shape, r.dtype, r.nbytes) for r in want]
    # torch's pytree walks dicts in insertion order: the port builds each
    # layer's dict sorted, so both list the leaves alike
    flat, _ = torch.utils._pytree.tree_flatten_with_path(template)
    assert [torch.utils._pytree.keystr(k) for k, _ in flat] == [r.path for r in want]
    gplan = unified.plan_state(got, n_slots=n_slots, max_len=max_len)
    wplan = jax_unified.plan_state(want, n_slots=n_slots, max_len=max_len)
    assert [(leaf.path, leaf.offset) for leaf in gplan.leaves] == [
        (leaf.path, leaf.offset) for leaf in wplan.leaves]
    assert gplan.total_size == wplan.total_size
    if variant == "full":
        # 13 shared K/V pairs at 32 x 224 and 81 conv windows and states
        _, H, conv_dim = ssm.ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                                      cfg.ssm_groups, cfg.ssm_state)
        raw = (13 * 2 * 2048 * 32 * 224
               + 81 * (3 * conv_dim + H * 64 * 64)) * 2 * 8
        assert raw == 6_730_313_728
        assert raw <= gplan.total_size < raw * 1.001


@pytest.mark.parametrize("variant", ["reduced", "full"])
def test_detect_state_axes_is_the_references(variant):
    """Slot axis 1 and length axis 2 on the shared K/V, no length axis on
    the Mamba2 leaves (slots on axis 1 in a period, 0 in the remainder)."""
    if variant == "full":
        jcfg, cfg, n, T = jax_get_config(ARCH), get_config(ARCH), 8, 2048
    else:
        jcfg, cfg, n, T = jax_get_reduced(ARCH), get_reduced(ARCH), 2, 32
    got = unified.detect_state_axes(DecoderModel(cfg, "cpu").init_cache,
                                    n_slots=n, max_len=T)
    want = jax_unified.detect_state_axes(Model.for_config(jcfg).init_cache,
                                         n_slots=n, max_len=T)
    assert got == want
    shared = [a for p, a in got.items() if "'shared'" in p]
    assert shared and set(shared) == {(1, 2)}
    for path, axes in got.items():
        if "'mamba'" in path:
            assert axes == ((1, None) if path.startswith("['period']") else (0, None))


# -------------------------------------------------------------- executor


@pytest.mark.parametrize("groups", GROUPS)
def test_executor_runs_the_hybrid_decode_step_as_eager(groups):
    jcfg, cfg, jparams, params = _pair(groups)
    model = DecoderModel(cfg, "cpu")
    B, T = 3, 16
    c_exec, c_eager = model.init_cache(B, T), model.init_cache(B, T)

    def decode(p, tables, t, c, pos, a):
        return model.decode_step(p, t, c, pos, a, **tables)

    ex = ArenaExecutor(decode, params, model.rope_tables,
                       torch.zeros((B, 1), dtype=torch.int32), c_exec,
                       torch.zeros(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool))
    rng = np.random.default_rng(11)
    pos = np.zeros(B, np.int32)
    for step in range(10):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32))
        active = torch.from_numpy(np.array([True, step % 3 != 2, step % 5 != 1]))
        got, _ = ex(params, model.rope_tables, tok, c_exec, torch.from_numpy(pos), active)
        want, _ = model.decode_step(params, tok, c_eager, torch.from_numpy(pos), active)
        assert torch.equal(got, want)
        assert all(torch.equal(g, w) for g, w in zip(_leaves(c_exec), _leaves(c_eager)))
        pos = pos + active.numpy().astype(np.int32)


@pytest.mark.parametrize("S", [40, 300])
@pytest.mark.parametrize("groups", GROUPS)
def test_executor_runs_the_hybrid_prefill_as_eager(groups, S):
    """At S = 300 the Mamba2 layers run two chunks, the second padded;
    equal to eager bit for bit, and to the reference within 1e-4."""
    jcfg, cfg, jparams, params = _pair(groups)
    model = DecoderModel(cfg, "cpu")
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (1, S)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens)}
    ex = ArenaExecutor(lambda p, tables, b: model.prefill(p, b, **tables),
                       params, model.rope_tables, batch)
    got_logits, got_caches = ex(params, model.rope_tables, batch)
    want_logits, want_caches = model.prefill(params, batch)
    lj, cj = Model.for_config(jcfg).prefill(jparams, {"tokens": jnp.asarray(tokens)})
    assert torch.equal(got_logits, want_logits)
    for g, w, j in zip(_leaves(got_caches), _leaves(want_caches),
                       jax.tree_util.tree_leaves(cj)):
        assert torch.equal(g, w)
        _close(g, j, 1e-4)
    _close(got_logits, lj, 1e-4)


@pytest.mark.parametrize("groups", GROUPS)
def test_the_traced_hybrid_prefill_plan_is_certified(groups):
    _, cfg = _configs(groups)
    graph, plan = plan_prefill(cfg, prefill_len=300)
    assert soundness.certify_plan(plan) == []
    assert plan.lower_bound <= plan.total_size < plan.naive_size
    ops = [op.name for op in graph.ops]
    assert sum("ssd_chunk" in o for o in ops) == 2 * cfg.n_layers  # two chunks


def test_the_engine_certifies_its_hybrid_plan():
    jcfg, cfg, jparams, params = _pair(2)
    eng = InferenceEngine(cfg, params, n_slots=2, max_len=32, device="cpu",
                          startup_lint=True)
    rep = eng.memory_report
    assert rep.startup_lint_findings == 0
    assert len(rep.state_plan.leaves) == 2 * 2 + 2  # 2 Mamba2 layers, 1 shared


# ------------------------------------------------------------------ RoPE


def test_the_shared_block_reads_its_own_rope_table():
    """The decode step's logits follow the shared table (at the block's
    head dim, 128 here, 224 at full width) and not the layers' (64 here,
    112 at full width), which zamba2's Mamba2 layers never read: garbage
    in the layers' table leaves the logits bit-equal, garbage in the
    shared one changes them."""
    jcfg, cfg, jparams, params = _pair(1)
    model = DecoderModel(cfg, "cpu")
    hd = transformer.shared_head_dim(cfg)
    assert torch.equal(model.shared_freqs,
                       torch.from_numpy(layers.rope_freqs(hd, cfg.rope_theta)))
    assert model.shared_freqs.shape == (hd // 2,) != model.rope_freqs.shape
    assert set(model.rope_tables) == {"rope_freqs", "shared_freqs"}
    B, T = 2, 8
    rng = np.random.default_rng(6)
    tokens = [torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32))
              for _ in range(4)]

    def run(**tables):
        caches = model.init_cache(B, T)
        out = []
        for i, tok in enumerate(tokens):
            logits, caches = model.decode_step(
                params, tok, caches, torch.full((B,), i, dtype=torch.int32), **tables)
            out.append(logits)
        return torch.stack(out)

    want = run()
    garbage = torch.full_like(model.rope_freqs, 7.0)
    assert torch.equal(run(rope_freqs=garbage), want)
    assert not torch.allclose(run(shared_freqs=model.shared_freqs * 0.5), want)
    jmodel = Model.for_config(jcfg)
    jc = jmodel.init_cache(B, T)
    for i, tok in enumerate(tokens):
        lj, jc = jmodel.decode_step(jparams, jnp.asarray(tok.numpy()), jc,
                                    jnp.full((B,), i, jnp.int32))
        _close(want[i], lj, 1e-4)


# -------------------------------------------------------------- roofline


def test_the_shared_block_is_counted_once_and_at_every_insertion():
    """``step_count`` reads each parameter once, the shared block too;
    ``shared_reread_bytes`` is what reading it again at each of its other
    insertions adds (12 x 1.079 GB at full width)."""
    full = get_config(ARCH)
    params = DecoderModel(full, "meta").init(None)
    block = sum(t.numel() * t.element_size()
                for t in _leaves(params["shared_attn"]))
    d2 = 2 * full.d_model
    assert block == (4 * d2 * d2 + 3 * d2 * full.d_ff + d2 * full.d_model) * 2 + 2 * d2 * 4
    assert roofline.shared_insertions(full) == 13
    assert roofline.shared_reread_bytes(full, params) == 12 * block
    assert roofline.count_params(full) == 7_006_114_816
    red = get_reduced(ARCH)
    assert roofline.shared_reread_bytes(red, DecoderModel(red, "meta").init(None)) == 0
    dense = get_reduced("qwen3-0.6b")
    assert roofline.shared_reread_bytes(dense, DecoderModel(dense, "meta").init(None)) == 0
