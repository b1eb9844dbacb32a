"""The VLM family (internvl2-1b): the port against ``repro.models`` and
``repro.runtime.engine``.

Float32, reduced internvl2 (d_model 256, 4/2 heads of 64, 8 prefix
embeddings), the reference's params bridged through numpy; the prefix
embeddings (the stub frontend's output) and the tokens from numpy seeds:

* ``forward`` and ``prefill`` with ``prefix_embeds`` in front of the
  tokens, then ``grow_caches`` and decode (which has no prefix), on both
  cores, against the reference's;
* the traced prefill takes the prefix as an input, counts it in
  ``prefill_len`` as the reference's ``input_specs`` does, is certified,
  and runs through ``ArenaExecutor`` bit for bit as eager;
* the engine's tokens, slot log and host syncs against the reference
  engine's;
* in bf16, ROADMAP C1's internvl2 case isolated: the port rounds as the
  reference run op by op (``jax.disable_jit``).

Tolerances: logits 1e-4, caches 1e-5 (fp32 summation order over a few
layers), as in ``test_torch_moe.py``.
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
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.models.api import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro.runtime import engine as jax_engine_mod  # noqa: E402
from repro_torch.analysis import soundness  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_config, get_reduced  # noqa: E402
from repro_torch.launch import compile as compile_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.api import FAMILIES, DecoderModel  # noqa: E402
from repro_torch.runtime import engine as engine_mod  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402
from repro_torch.runtime.executor import ArenaExecutor  # noqa: E402

ARCH = "internvl2-1b"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@functools.cache
def _pair():
    jcfg, cfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_numpy(cfg, _np_tree(jparams), "cpu")


def _batch(cfg, B: int, S: int, seed: int):
    """(numpy prefix embeddings (B, P, d_model), numpy tokens (B, S))."""
    rng = np.random.default_rng(seed)
    prefix = rng.standard_normal((B, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return prefix, rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)


def _jax(prefix, tokens):
    return {"prefix_embeds": jnp.asarray(prefix), "tokens": jnp.asarray(tokens)}


def _torch(prefix, tokens):
    return {"prefix_embeds": torch.from_numpy(prefix), "tokens": torch.from_numpy(tokens)}


# ------------------------------------------------------------- configs


def test_internvl2_is_ported_as_the_reference():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(
        jax_get_config(ARCH))
    assert dataclasses.asdict(get_reduced(ARCH)) == dataclasses.asdict(
        jax_get_reduced(ARCH))
    assert "vlm" in FAMILIES
    full = get_config(ARCH)
    assert (full.n_prefix_tokens, full.n_heads // full.n_kv_heads,
            full.resolved_head_dim) == (256, 7, 64)
    assert get_reduced(ARCH).n_prefix_tokens == 8


# ------------------------------------------------------------- model


@pytest.mark.parametrize("cores", ["kernel", "plain"])
def test_forward_with_the_prefix_matches_the_reference(cores):
    jcfg, cfg, jparams, params = _pair()
    prefix, tokens = _batch(cfg, 2, 40, 1)
    want, _ = Model.for_config(jcfg).forward(jparams, _jax(prefix, tokens))
    got, aux = DecoderModel(cfg, "cpu", cores=cores).forward(params, _torch(prefix, tokens))
    assert got.shape == (2, cfg.n_prefix_tokens + 40, cfg.vocab)
    _close(got, want, 1e-4)
    assert float(aux) == 0.0
    # the prefix counts: without it the logits are others
    alone, _ = DecoderModel(cfg, "cpu", cores=cores).forward(
        params, {"tokens": torch.from_numpy(tokens)})
    assert not torch.allclose(alone[:, -1], got[:, -1], atol=1e-3)


def test_the_prefix_is_cast_to_the_models_dtype():
    """bf16 model, fp32 embeddings: cast before the concatenation, as in
    the reference."""
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="bfloat16")
    params = DecoderModel(cfg, "cpu").init(torch.Generator().manual_seed(0))
    prefix, tokens = _batch(cfg, 1, 6, 2)
    h = transformer._embed(params, torch.from_numpy(tokens), torch.from_numpy(prefix))
    assert h.dtype == torch.bfloat16 and h.shape == (1, cfg.n_prefix_tokens + 6,
                                                      cfg.d_model)
    assert torch.equal(h[:, :cfg.n_prefix_tokens],
                       torch.from_numpy(prefix).to(torch.bfloat16))


@pytest.mark.parametrize("cores", ["kernel", "plain"])
def test_prefill_with_the_prefix_then_decode_gives_the_references_logits(cores):
    """Prefill 8 embeddings + 12 tokens, grow the caches to 40, decode 4
    more tokens (decode has no prefix)."""
    jcfg, cfg, jparams, params = _pair()
    jmodel, model = Model.for_config(jcfg), DecoderModel(cfg, "cpu", cores=cores)
    S, steps, B = 12, 4, 2
    prefix, tokens = _batch(cfg, B, S + steps, 3)
    P = cfg.n_prefix_tokens
    lj, jc = jmodel.prefill(jparams, _jax(prefix, tokens[:, :S]))
    lt, tc = model.prefill(params, _torch(prefix, tokens[:, :S]))
    _close(lt, lj, 1e-4)
    for g, w in zip(_leaves(tc), jax.tree_util.tree_leaves(jc)):
        assert g.shape[-3] == P + S
        _close(g, w, 1e-5)
    jc = jax_transformer.grow_caches(jcfg, jc, 40)
    tc = transformer.grow_caches(cfg, tc, 40)
    decode = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, t, c, pos))
    for i in range(S, S + steps):
        pos = np.full(B, P + i, np.int32)
        lj, jc = decode(jparams, jnp.asarray(tokens[:, i:i + 1]), jc, jnp.asarray(pos))
        lt, tc = model.decode_step(params, torch.from_numpy(tokens[:, i:i + 1]), tc,
                                   torch.from_numpy(pos))
        _close(lt, lj, 1e-4)


# ------------------------------------------------------------- prefill plan


def test_prefill_len_counts_the_prefix_as_the_reference():
    """A 2048-position prefill is 256 embeddings and 1792 tokens (the
    reference's ``input_specs`` at batch 1); a prefill no longer than the
    prefix keeps one token."""
    cfg = get_config(ARCH)
    jspecs = Model.for_config(jax_get_config(ARCH)).input_specs(
        dataclasses.replace(JAX_INPUT_SHAPES["prefill_32k"], seq_len=2048,
                            global_batch=1))
    batch = compile_mod.prefill_batch(cfg, 2048, "meta")
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        k: tuple(v.shape) for k, v in jspecs.items()} == {
        "tokens": (1, 1792), "prefix_embeds": (1, 256, cfg.d_model)}
    assert batch["prefix_embeds"].dtype == torch.bfloat16
    assert compile_mod.prefill_batch(cfg, 100, "meta")["tokens"].shape == (1, 1)
    assert set(compile_mod.prefill_batch(get_config("qwen3-0.6b"), 64, "meta")) == {
        "tokens"}


def test_the_traced_prefill_with_the_prefix_is_certified():
    cfg = get_reduced(ARCH)
    graph, plan = compile_mod.plan_prefill(cfg, prefill_len=300)
    assert soundness.certify_plan(plan) == []
    assert plan.lower_bound <= plan.total_size < plan.naive_size
    # the prefix is an input of the graph (read, never produced), and the
    # embeddings it is put in front of fill the other 292 positions
    produced = {t for op in graph.ops for t in op.outputs}
    inputs = {tuple(graph.tensors[t].shape) for op in graph.ops for t in op.inputs
              if t not in produced}
    assert (1, cfg.n_prefix_tokens, cfg.d_model) in inputs
    assert (1, 300 - cfg.n_prefix_tokens) in inputs


@pytest.mark.parametrize("S", [20, 300])
def test_executor_runs_the_prefix_prefill_as_eager(S):
    """Through ``ArenaExecutor`` from the plan of the traced prefill, bit
    for bit as eager and within 1e-4 of the reference."""
    jcfg, cfg, jparams, params = _pair()
    model = DecoderModel(cfg, "cpu")
    prefix, tokens = _batch(cfg, 1, S, 4)
    batch = _torch(prefix, tokens)
    _, plan = compile_mod.plan_prefill(cfg, prefill_len=cfg.n_prefix_tokens + S)
    ex = ArenaExecutor(lambda p, tables, b: model.prefill(p, b, **tables),
                       params, model.rope_tables, batch, plan=plan)
    got_logits, got_caches = ex(params, model.rope_tables, batch)
    want_logits, want_caches = model.prefill(params, batch)
    assert torch.equal(got_logits, want_logits)
    assert all(torch.equal(g, w) for g, w in zip(_leaves(got_caches),
                                                  _leaves(want_caches)))
    lj, _ = Model.for_config(jcfg).prefill(jparams, _jax(prefix, tokens))
    _close(got_logits, lj, 1e-4)


# -------------------------------------------------------------- engine


PROMPT_LENS = (12, 20, 12, 20)
MAX_NEW = (6, 4, 9, 5)


def test_engine_matches_the_reference_engine():
    """Decode serves internvl2 as a dense decoder (no prefix, as the
    reference engine): tokens, slot log, host syncs and state bytes."""
    jcfg, cfg, jparams, params = _pair()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in PROMPT_LENS]
    results = []
    for eng, mod in (
            (jax_engine_mod.InferenceEngine(jcfg, jparams, n_slots=2, max_len=64),
             jax_engine_mod),
            (InferenceEngine(cfg, params, n_slots=2, max_len=64, device="cpu"),
             engine_mod)):
        for prompt, new in zip(prompts, MAX_NEW):
            eng.submit(prompt, max_new_tokens=new)
        syncs = mod.HOST_SYNCS
        done = eng.run_until_done(raise_on_exhausted=True)
        results.append(({r.request_id: list(r.tokens) for r in done},
                        mod.HOST_SYNCS - syncs, eng))
    (want, want_syncs, jeng), (got, got_syncs, eng) = results
    assert got == want
    assert eng.slot_log == jeng.slot_log
    assert got_syncs == want_syncs == eng.waves
    assert eng.memory_report.state_live_bytes == jeng.memory_report.state_live_bytes


# ------------------------------------------------------ bf16 (ROADMAP C1)


def test_bf16_internvl2_decode_rounds_as_the_reference_op_by_op():
    """ROADMAP C1's bf16 decode of reduced internvl2 (12 steps, 2 slots,
    the same tokens), the reference both compiled and op by op
    (``jax.disable_jit``). The port's logits are within C1's bars of the
    op-by-op reference (measured: 0.71x its own largest bf16 error, RMS
    0.99x), as they are for granite. C1 holds them to the compiled
    reference, whose logits differ from its own op-by-op logits by more
    than the port's do (measured 1.13x the op-by-op run's largest bf16
    error): XLA's compiled step rounds otherwise than the reference's own
    ops."""
    j16 = dataclasses.replace(jax_get_reduced(ARCH), dtype="bfloat16")
    j32 = jax_get_reduced(ARCH)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="bfloat16")
    p16 = Model.for_config(j16).init(jax.random.PRNGKey(0))
    p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p16)
    params = params_from_numpy(cfg, _np_tree(p16), "cpu")
    m16, m32 = Model.for_config(j16), Model.for_config(j32)
    B, T, steps = 2, 16, 12
    ce, c32 = m16.init_cache(B, T), m32.init_cache(B, T)
    model = DecoderModel(cfg, "cpu", cores="plain")
    caches = model.init_cache(B, T)
    d32 = jax.jit(lambda p, t, c, pos: m32.decode_step(p, t, c, pos))
    rng = np.random.default_rng(13)
    ref, ref32, port = [], [], []
    for i in range(steps):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        pos = np.full(B, i, np.int32)
        with jax.disable_jit():
            le, ce = m16.decode_step(p16, jnp.asarray(tok), ce, jnp.asarray(pos))
        l32, c32 = d32(p32, tok, c32, pos)
        with torch.no_grad():
            lt, caches = model.decode_step(params, torch.from_numpy(tok), caches,
                                           torch.from_numpy(pos))
        ref.append(np.asarray(le.astype(jnp.float32)))
        ref32.append(np.asarray(l32))
        port.append(lt.float().numpy())
    ref, ref32, port = map(np.stack, (ref, ref32, port))
    own = float(np.abs(ref - ref32).max())
    assert 0 < own < 0.1 * float(np.abs(ref32).max())
    assert float(np.abs(port - ref).max()) <= 1.25 * own

    def rms(a):
        return float(np.sqrt(np.mean(a * a)))

    assert rms(port - ref32) <= 1.1 * rms(ref - ref32)
