"""gemma3's sliding-window attention, attention prefill and the nemotron
reduced config: the port against ``repro.models`` and ``repro.runtime``.

Float32, reduced configs, the reference's params bridged through numpy,
inputs from numpy seeds:

* windowed ``attn_decode`` (both cores) equals the reference's past
  three wraps of the ring, with inactive rows;
* ``attn_prefill`` equals the reference on each of its branches — one
  chunk, the unrolled causal path, the window's key slices, the window
  cache of a prompt shorter than the window, and the masked long-S path
  — in its output and its caches;
* ``grow_caches`` equals the reference's, and a prefill followed by
  decode steps gives the reference's logits;
* the engine on reduced gemma3 with a window of 8 in both packages
  (prompts of 12 and 20 tokens on 2 slots: rings wrap, slots are reused)
  gives the reference engine's tokens, slot log, host syncs and state
  bytes; the same for reduced nemotron-4-340b;
* ``ArenaExecutor`` runs the gemma3 decode step and attention prefill
  bit for bit as eager, and the traced prefill plans of qwen3 and gemma3
  are certified;
* in bf16 (ROADMAP C1), 12 decode steps of reduced qwen3, mamba2 and
  gemma3 on the plain cores stay within the reference's own bf16-vs-fp32
  difference of the reference's bf16 logits.

Tolerances: outputs of one layer 1e-5, logits 1e-4 (fp32 summation
order over a few layers), as in ``test_torch_model.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.unified import detect_state_axes as jax_detect_state_axes  # noqa: E402
from repro.core.unified import plan_state as jax_plan_state  # noqa: E402
from repro.core.unified import state_records_from_pytree  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro.runtime import engine as jax_engine_mod  # noqa: E402
from repro_torch.analysis import soundness  # noqa: E402
from repro_torch.bridge import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_config, get_reduced  # noqa: E402
from repro_torch.core.unified import detect_state_axes, plan_state  # noqa: E402
from repro_torch.core.unified import state_records_from_cache  # noqa: E402
from repro_torch.launch import roofline  # noqa: E402
from repro_torch.launch.compile import plan_prefill  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models.api import DecoderModel  # noqa: E402
from repro_torch.runtime import engine as engine_mod  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402
from repro_torch.runtime.executor import ArenaExecutor  # noqa: E402

ARCH = "gemma3-4b"
WINDOW = 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _windowed(cfg, window):
    """``cfg`` with every window layer's window replaced by ``window``."""
    def swap(specs):
        return tuple(dataclasses.replace(s, window=window) if s.window else s
                     for s in specs)

    return dataclasses.replace(cfg, period=swap(cfg.period),
                               remainder=swap(cfg.remainder))


def _pair(arch, window=None):
    """(jax cfg, port cfg, jax params, port params) of ``arch`` reduced."""
    jcfg, cfg = jax_get_reduced(arch), get_reduced(arch)
    if window is not None:
        jcfg, cfg = _windowed(jcfg, window), _windowed(cfg, window)
    jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_numpy(cfg, _np_tree(jparams), "cpu")


@pytest.fixture(scope="module")
def gemma():
    return _pair(ARCH, WINDOW)


# ------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", ["gemma3-4b", "gemma3-27b"])
def test_gemma3_is_ported_as_the_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_get_config(arch))
    assert dataclasses.asdict(get_reduced(arch)) == dataclasses.asdict(
        jax_get_reduced(arch))
    red = get_reduced(arch)
    assert [s.window for s in red.period] == [1024, None]


def test_nemotron_has_its_reduced_config_only():
    assert dataclasses.asdict(get_reduced("nemotron-4-340b")) == dataclasses.asdict(
        jax_get_reduced("nemotron-4-340b"))
    with pytest.raises(NotImplementedError, match="A15"):
        get_config("nemotron-4-340b")


def test_gemma3_4b_state_is_the_rings_and_the_global_caches():
    """8 slots x 2048 positions, bf16: 29 rings of 1024 positions and 5
    global caches of 2048, 5,120 B of K+V per position per layer — the
    reference's plan to the byte, with no alignment padding."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    n, T = 8, 2048
    got = plan_state(state_records_from_cache(transformer.init_cache(cfg, n, T, "meta"),
                                              n_slots=n), n_slots=n, max_len=T)
    template = jax.eval_shape(lambda: Model.for_config(jcfg).init_cache(n, T))
    want = jax_plan_state(state_records_from_pytree(template, n_slots=n),
                          n_slots=n, max_len=T)
    assert got.total_size == want.total_size == 1_635_778_560
    assert got.total_size == (5 * n * T + 29 * n * 1024) * 5120
    assert [(leaf.path, leaf.offset) for leaf in got.leaves] == [
        (leaf.path, leaf.offset) for leaf in want.leaves]


@pytest.mark.parametrize("max_len", [16, 1024, 2048])
def test_detect_state_axes_finds_the_rings_as_the_reference(max_len):
    """A ring's extent follows max_len only while max_len + 8 <= window."""
    cfg, jcfg = get_reduced(ARCH), jax_get_reduced(ARCH)
    got = detect_state_axes(DecoderModel(cfg, "meta").init_cache, n_slots=2,
                            max_len=max_len)
    model = Model.for_config(jcfg)
    want = jax_detect_state_axes(lambda n, t: model.init_cache(n, t), n_slots=2,
                                 max_len=max_len)
    assert got == want
    ring = "['period'][0]['attn'][0]"
    assert got[ring] == ((1, 2) if max_len + 8 <= 1024 else (1, None))
    assert got["['period'][1]['attn'][0]"] == (1, 2)


# ------------------------------------------------------- decode layer


@pytest.mark.parametrize("core", ["plain", "kernel"])
def test_windowed_decode_matches_the_reference_past_three_wraps(gemma, core):
    jcfg, cfg, jparams, params = gemma
    rng = np.random.default_rng(3)
    B, T = 3, WINDOW
    p_j = jax.tree_util.tree_map(lambda a: a[0], jparams["period"][0]["attn"])
    p_t = {k: v[0] for k, v in params["period"][0]["attn"].items()}
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta, window=WINDOW)
    shape = (B, T, cfg.n_kv_heads, cfg.resolved_head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jcache = (jnp.asarray(kc), jnp.asarray(vc))
    cache = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))
    fn = attention.attn_decode if core == "plain" else attention.attn_decode_kernel
    pos = np.array([0, 3, 7], np.int32)
    for step in range(4 * T + 4):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        active = np.array([True, step % 3 != 1, step % 4 != 0])
        want, jcache = jax_attn.attn_decode(p_j, jnp.asarray(x), jcache,
                                            jnp.asarray(pos), active=jnp.asarray(active),
                                            **kw)
        got, out = fn(p_t, torch.from_numpy(x), cache, torch.from_numpy(pos),
                      active=torch.from_numpy(active), **kw)
        assert out[0] is cache[0] and out[1] is cache[1]  # written in place
        _close(got, want, 1e-5)
        for g, w in zip(cache, jcache):
            _close(g, w, 1e-5)
        pos = pos + active.astype(np.int32)
    assert pos.min() > 3 * T  # every row wrapped its ring three times


# ------------------------------------------------------------- prefill


# (S, window, q_chunk, the branch of attn_prefill it reaches)
PREFILL_CASES = [
    (5, None, 512, "single_chunk"),
    (40, None, 8, "causal_unroll"),
    (40, 12, 8, "window_slices"),
    (43, 12, 8, "window_slices_padded"),
    (5, 12, 512, "window_cache_shorter_than_window"),
    (20, 12, 512, "window_single_chunk_past_the_window"),
]


@pytest.mark.parametrize("S,window,q_chunk,branch", PREFILL_CASES,
                         ids=[c[-1] for c in PREFILL_CASES])
def test_attn_prefill_matches_the_reference(gemma, S, window, q_chunk, branch):
    jcfg, cfg, jparams, params = gemma
    p_j = jax.tree_util.tree_map(lambda a: a[0], jparams["period"][0]["attn"])
    p_t = {k: v[0] for k, v in params["period"][0]["attn"].items()}
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta, window=window,
              q_chunk=q_chunk)
    x = np.random.default_rng(7).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want, (kj, vj) = jax_attn.attn_prefill(p_j, jnp.asarray(x), **kw)
    got, (k, v) = attention.attn_prefill(p_t, torch.from_numpy(x), **kw)
    assert got.shape == want.shape and k.shape == kj.shape
    assert k.shape[1] == (window if window else S)
    _close(got, want, 1e-5)
    _close(k, kj, 1e-5)
    _close(v, vj, 1e-5)


def test_attn_prefill_masked_long_path_matches_the_reference():
    """S > 8192 without a window: each of 5 query chunks of 2048 (the last
    padded) masks the whole (C, S) tile. Two heads of 16 on a 32-wide
    model keep the (C, S) scores small."""
    rng = np.random.default_rng(8)
    d, H, KV, hd, S = 32, 2, 1, 16, 8200
    p = {"wq": rng.uniform(-0.2, 0.2, (d, H * hd)), "wk": rng.uniform(-0.2, 0.2, (d, KV * hd)),
         "wv": rng.uniform(-0.2, 0.2, (d, KV * hd)), "wo": rng.uniform(-0.2, 0.2, (H * hd, d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((1, S, d)).astype(np.float32)
    kw = dict(n_heads=H, n_kv=KV, head_dim=hd, theta=10_000.0, window=None,
              q_chunk=2048)
    want, (kj, _) = jax_attn.attn_prefill(p, jnp.asarray(x), **kw)
    got, (k, _) = attention.attn_prefill({n: torch.from_numpy(a) for n, a in p.items()},
                                         torch.from_numpy(x), **kw)
    _close(got, want, 1e-5)
    _close(k, kj, 1e-5)


# ------------------------------------------------- prefill into decode


def test_grow_caches_matches_the_reference(gemma):
    jcfg, cfg, jparams, params = gemma
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    _, jcaches = Model.for_config(jcfg).prefill(jparams, {"tokens": jnp.asarray(tokens)})
    _, caches = DecoderModel(cfg, "cpu").prefill(params, {"tokens": torch.from_numpy(tokens)})
    for new_len in (4, 12, 32):
        want = jax_transformer.grow_caches(jcfg, jcaches, new_len)
        got = transformer.grow_caches(cfg, caches, new_len)
        assert [tuple(g.shape) for g in _leaves(got)] == [
            tuple(w.shape) for w in jax.tree_util.tree_leaves(want)]
        for g, w in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
            _close(g, w, 1e-5)
    grown = transformer.grow_caches(cfg, caches, 32)
    ring, glob = grown["period"][0]["attn"][0], grown["period"][1]["attn"][0]
    assert ring.shape[2] == WINDOW and glob.shape[2] == 32
    assert ring is caches["period"][0]["attn"][0]  # a ring keeps its size


@pytest.mark.parametrize("arch,window", [(ARCH, WINDOW), ("qwen3-0.6b", None),
                                         ("nemotron-4-340b", None)])
def test_prefill_then_decode_gives_the_references_logits(arch, window):
    """Prefill 12 tokens (past the window of 8), grow the caches to 32,
    decode 10 more: every step's logits are the reference's."""
    jcfg, cfg, jparams, params = _pair(arch, window)
    jmodel, model = Model.for_config(jcfg), DecoderModel(cfg, "cpu")
    rng = np.random.default_rng(10)
    S, steps, B = 12, 10, 2
    tokens = rng.integers(0, cfg.vocab, (B, S + steps)).astype(np.int32)
    lj, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens[:, :S])})
    lt, tc = model.prefill(params, {"tokens": torch.from_numpy(tokens[:, :S])})
    _close(lt, lj, 1e-4)
    jc = jax_transformer.grow_caches(jcfg, jc, 32)
    tc = transformer.grow_caches(cfg, tc, 32)
    decode = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, t, c, pos))
    for i in range(S, S + steps):
        pos = np.full(B, i, np.int32)
        lj, jc = decode(jparams, jnp.asarray(tokens[:, i:i + 1]), jc, jnp.asarray(pos))
        lt, tc = model.decode_step(params, torch.from_numpy(tokens[:, i:i + 1]), tc,
                                   torch.from_numpy(pos))
        _close(lt, lj, 1e-4)


# ---------------------------------------------------------------- engine


PROMPT_LENS = (12, 20, 12, 20)
MAX_NEW = (6, 4, 9, 5)


def _serve(engine, mod, prompts):
    for prompt, new in zip(prompts, MAX_NEW):
        engine.submit(prompt, max_new_tokens=new)
    syncs = mod.HOST_SYNCS
    done = engine.run_until_done(raise_on_exhausted=True)
    return {r.request_id: list(r.tokens) for r in done}, mod.HOST_SYNCS - syncs


@pytest.mark.parametrize("arch,window", [(ARCH, WINDOW), ("nemotron-4-340b", None)])
def test_engine_matches_the_reference_engine(arch, window):
    jcfg, cfg, jparams, params = _pair(arch, window)
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
    if window:
        ring = eng.caches["period"][0]["attn"][0]
        assert ring.shape[2] == window < max(PROMPT_LENS)  # the rings wrapped


# -------------------------------------------------------------- executor


def test_executor_runs_the_gemma3_decode_step_as_eager(gemma):
    jcfg, cfg, jparams, params = gemma
    model = DecoderModel(cfg, "cpu")
    B, T = 3, 16
    c_exec, c_eager = model.init_cache(B, T), model.init_cache(B, T)

    def decode(p, f, t, c, pos, a):
        return model.decode_step(p, t, c, pos, a, rope_freqs=f)

    ex = ArenaExecutor(decode, params, model.rope_freqs,
                       torch.zeros((B, 1), dtype=torch.int32), c_exec,
                       torch.zeros(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool))
    rng = np.random.default_rng(11)
    pos = np.zeros(B, np.int32)
    for step in range(3 * WINDOW):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32))
        active = torch.from_numpy(np.array([True, step % 3 != 2, step % 5 != 1]))
        got, _ = ex(params, model.rope_freqs, tok, c_exec, torch.from_numpy(pos), active)
        want, _ = model.decode_step(params, tok, c_eager, torch.from_numpy(pos), active)
        assert torch.equal(got, want)
        assert all(torch.equal(g, w) for g, w in zip(_leaves(c_exec), _leaves(c_eager)))
        pos = pos + active.numpy().astype(np.int32)


@pytest.mark.parametrize("S", [20, 600])
def test_executor_runs_attention_prefill_as_eager(gemma, S):
    """The model's prefill (q_chunk 512) through the executor: at S = 20
    one query chunk; at S = 600 two unrolled causal chunks (the last
    padded) on the global layer and two window slices on the window
    layer. Logits and caches (the ring, the whole K/V) equal eager bit
    for bit, and the reference within 1e-4."""
    jcfg, cfg, jparams, params = gemma
    model = DecoderModel(cfg, "cpu")
    tokens = np.random.default_rng(12).integers(0, cfg.vocab, (1, S)).astype(np.int32)
    tt = torch.from_numpy(tokens)
    ex = ArenaExecutor(lambda p, f, t: model.prefill(p, {"tokens": t}, rope_freqs=f),
                       params, model.rope_freqs, tt)
    got_logits, got_caches = ex(params, model.rope_freqs, tt)
    want_logits, want_caches = model.prefill(params, {"tokens": tt})
    lj, cj = Model.for_config(jcfg).prefill(jparams, {"tokens": jnp.asarray(tokens)})
    assert torch.equal(got_logits, want_logits)
    for g, w, j in zip(_leaves(got_caches), _leaves(want_caches),
                       jax.tree_util.tree_leaves(cj)):
        assert torch.equal(g, w)
        _close(g, j, 1e-4)
    _close(got_logits, lj, 1e-4)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", ARCH])
def test_the_traced_attention_prefill_plan_is_certified(arch):
    cfg = get_reduced(arch)
    graph, plan = plan_prefill(cfg, prefill_len=300)
    assert soundness.certify_plan(plan) == []
    assert plan.lower_bound <= plan.total_size < plan.naive_size
    ops = [op.name for op in graph.ops]
    assert not any("ssd_chunk" in o or "flash_decode" in o for o in ops)


# -------------------------------------------------------------- roofline


def test_step_count_reads_a_ring_up_to_its_window(gemma):
    """Reduced gemma3 with a window of 8 at 2 slots x 32 positions: the
    ring has no token axis, and its least read is min(length, 8) rows
    of each slot, where the global layer reads min(length, 32)."""
    jcfg, cfg, jparams, params = gemma
    B, T = 2, 32
    eng = InferenceEngine(cfg, params, n_slots=B, max_len=T, device="cpu")
    model = eng.model
    axes = detect_state_axes(model.init_cache, n_slots=B, max_len=T)
    rings = roofline.ring_windows(cfg, eng.caches)
    assert set(rings) == {"['period'][0]['attn'][0]", "['period'][0]['attn'][1]"}
    assert axes["['period'][0]['attn'][0]"] == (1, None)
    inputs = (model.rope_freqs, torch.zeros((B, 1), dtype=torch.int32),
              torch.zeros(B, dtype=torch.int32), torch.ones(B, dtype=torch.bool))
    row = cfg.n_kv_heads * cfg.resolved_head_dim * 4  # one position, fp32
    lengths = [5, 20]
    count = roofline.step_count(eng.executor.trace, params, inputs, state=eng.caches,
                                axes=axes, lengths=lengths, rings=rings)
    assert count.state_read_bytes == 2 * row * ((5 + WINDOW) + (5 + 20))
    assert count.state_write_bytes == 2 * row * B * 2
    whole = roofline.step_count(eng.executor.trace, params, inputs, state=eng.caches,
                                axes=axes, lengths=lengths)
    assert whole.state_read_bytes == 2 * row * (B * WINDOW + (5 + 20))
    H, D = cfg.n_heads, cfg.resolved_head_dim
    assert count.flops_by_op["repro_torch.flash_decode"] == 4 * 25 * H * D


# ------------------------------------------------------ bf16 (ROADMAP C1)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-2.7b", ARCH,
                                  "granite-moe-3b-a800m", "zamba2-7b",
                                  "internvl2-1b"])
def test_bf16_decode_stays_within_the_references_own_bf16_error(arch):
    """12 decode steps of 2 slots on the same tokens: the reference in bf16
    and in fp32 (the same bf16 weights, upcast), and the port in bf16 on
    the plain cores. The port's bf16 logits are as close to the fp32
    reference as the reference's own bf16 logits: their RMS error within
    10% of the reference's, and their largest difference from the
    reference's bf16 logits within 1.25x the reference's own largest
    bf16 error (the two round at different places, so they differ by
    about as much as each differs from fp32). Measured: 0.87-1.03 and at
    most 1.12. An rms_norm computed in bf16 (a cast point moved) gives
    1.19-1.21 and 1.54-1.71. Not a token-equality test."""
    j32 = jax_get_reduced(arch)
    j16 = dataclasses.replace(j32, dtype="bfloat16")
    cfg = dataclasses.replace(get_reduced(arch), dtype="bfloat16")
    p16 = Model.for_config(j16).init(jax.random.PRNGKey(0))
    p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p16)
    params = params_from_numpy(cfg, _np_tree(p16), "cpu")
    m16, m32 = Model.for_config(j16), Model.for_config(j32)
    B, T, steps = 2, 16, 12
    c16, c32 = m16.init_cache(B, T), m32.init_cache(B, T)
    model = DecoderModel(cfg, "cpu", cores="plain")
    caches = cache_from_numpy(cfg, _np_tree(m16.init_cache(B, T)), "cpu")
    d16 = jax.jit(lambda p, t, c, pos: m16.decode_step(p, t, c, pos))
    d32 = jax.jit(lambda p, t, c, pos: m32.decode_step(p, t, c, pos))
    rng = np.random.default_rng(13)
    ref16, ref32, port = [], [], []
    for i in range(steps):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        pos = np.full(B, i, np.int32)
        l16, c16 = d16(p16, tok, c16, pos)
        l32, c32 = d32(p32, tok, c32, pos)
        lt, caches = model.decode_step(params, torch.from_numpy(tok), caches,
                                       torch.from_numpy(pos))
        assert lt.dtype == torch.bfloat16
        ref16.append(np.asarray(l16.astype(jnp.float32)))
        ref32.append(np.asarray(l32))
        port.append(lt.float().numpy())
    ref16, ref32, port = map(np.stack, (ref16, ref32, port))
    own = float(np.abs(ref16 - ref32).max())
    assert 0 < own < 0.1 * float(np.abs(ref32).max())
    assert float(np.abs(port - ref16).max()) <= 1.25 * own

    def rms(a):
        return float(np.sqrt(np.mean(a * a)))

    assert rms(port - ref32) <= 1.1 * rms(ref16 - ref32)
