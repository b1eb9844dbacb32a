"""Paged state in the port (``repro_torch.runtime.paging``) against the
JAX paged engine and against the port's own symmetric engine.

Reduced configs in float32, 2 slots x 64 positions, as
``tests/test_paging.py``. On the CPU the port's decode step writes each
new K/V row through the page table and reads the cache through the plain
version of ``flash_decode_paged`` (gather, then ``flash_decode_ref``):

* against ``repro.runtime.engine.InferenceEngine(..., page_size=...)``
  (params bridged through numpy): tokens, slot log, page log and the
  peak of live pages equal, the caches gathered through the table within
  1e-5 of the JAX engine's, host loop and blocks, for every decoder
  family (qwen3, granite-moe, internvl2, gemma3 with its window at 1024
  and cut to 8 so that every ring wraps, mamba2, zamba2); the memory
  report's paged fields equal;
* against the port's symmetric engine: tokens identical and every cache
  leaf byte-identical at page sizes 1024, 1000 and 4096, seeded sampling
  included, for qwen3, both ring branches of gemma3 (token-paged and
  fully live), mamba2 and zamba2;
* ``flash_decode_paged_ref`` against the reference's oracle on the
  reference's ``unpack`` of the same pool and table, and the paged K/V
  write against the reference's ``unpack``, row update and ``pack``;
* the ring mask of the plain decode against the kernel core's lengths,
  ``PagedLeaf.put`` against ``gather`` and its neighbours, the null page
  under steals, and no whole-region gather on the served step;
* pool pressure and the serve CLI.
"""

import dataclasses
import functools
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.core.unified import detect_state_axes as jax_detect_state_axes  # noqa: E402
from repro.core.unified import plan_paged_state as jax_plan_paged_state  # noqa: E402
from repro.core.unified import state_records_from_pytree  # noqa: E402
from repro.kernels.ref import flash_decode_ref as jax_flash_decode_ref  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro.runtime import engine as jax_engine_mod  # noqa: E402
from repro.runtime import paging as jax_paging  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.core.shared_objects import from_page_log  # noqa: E402
from repro_torch.core.unified import (detect_state_axes, plan_paged_state,  # noqa: E402
                                      plan_state, state_records_from_cache)
from repro_torch.kernels.flash_decode import flash_decode_paged  # noqa: E402
from repro_torch.kernels.ref import flash_decode_paged_ref, paged_index  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.api import DecoderModel  # noqa: E402
from repro_torch.models.attention import _write_kv_paged  # noqa: E402
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402
from repro_torch.runtime.paging import (PagedOutOfPagesError,  # noqa: E402
                                        PagedResidentState, PagedStateResidency)

N_SLOTS, MAX_LEN, MAX_NEW = 2, 64, 6
SIZES = (4, 6, 3, 5, 4)


def _windowed(cfg, window):
    """``cfg`` with every sliding window cut to ``window`` (None: as is)."""
    if window is None:
        return cfg
    def cut(specs):
        return tuple(dataclasses.replace(s, window=window) if s.window else s
                     for s in specs)
    return dataclasses.replace(cfg, period=cut(cfg.period), remainder=cut(cfg.remainder))


@functools.lru_cache(maxsize=None)
def _params(arch, window=None):
    """The reference's params and the same params in the port."""
    jcfg = _windowed(jax_get_reduced(arch), window)
    cfg = _windowed(get_reduced(arch), window)
    jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, jparams, cfg, params


def _prompts(cfg, sizes=SIZES):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in sizes]


def _run(engine, prompts, max_new=MAX_NEW, **kw):
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new)
    done = engine.run_until_done(**kw)
    return {r.request_id: list(r.tokens) for r in done}


def _port(arch, window=None, **kw):
    _, _, cfg, params = _params(arch, window)
    return InferenceEngine(cfg, params, n_slots=N_SLOTS, max_len=MAX_LEN,
                           device="cpu", **kw)


def _leaves(caches):
    return pytree.tree_leaves(caches)


def _assert_byte_identical(a, b):
    for x, y in zip(_leaves(a.caches), _leaves(b.caches), strict=True):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.contiguous().view(torch.uint8).numpy().tobytes() == \
            y.contiguous().view(torch.uint8).numpy().tobytes()


# ------------------------------------------------ against the JAX engine


# (arch, window): gemma3 with its window cut to 8 wraps every ring; its
# prompts (up to 12) and 9 new tokens run each slot past 8 positions
FAMILIES = [("qwen3-0.6b", None), ("granite-moe-3b-a800m", None),
            ("internvl2-1b", None), ("gemma3-4b", None), ("gemma3-4b", 8),
            ("mamba2-2.7b", None), ("zamba2-7b", None)]
WRAP_SIZES, WRAP_NEW = (4, 12, 3, 9, 4), 9


def _case(arch, window):
    """Prompts and new tokens of a case: the wrapping ones for a cut
    window."""
    cfg = _params(arch, window)[2]
    if window is None:
        return _prompts(cfg), MAX_NEW
    return _prompts(cfg, WRAP_SIZES), WRAP_NEW


@pytest.mark.parametrize("block_size", [1, 4])
@pytest.mark.parametrize("arch,window", FAMILIES)
def test_paged_engine_matches_the_jax_paged_engine(arch, window, block_size):
    jcfg, jparams, cfg, _ = _params(arch, window)
    prompts, max_new = _case(arch, window)
    jeng = jax_engine_mod.InferenceEngine(jcfg, jparams, n_slots=N_SLOTS,
                                          max_len=MAX_LEN, page_size=1024,
                                          block_size=block_size)
    want = _run(jeng, prompts, max_new)
    eng = _port(arch, window, page_size=1024, block_size=block_size)
    ptr = eng.state.buf.data_ptr()
    got = _run(eng, prompts, max_new)
    assert got == want
    assert eng.slot_log == jeng.slot_log
    assert eng.page_log == jeng.page_log and eng.page_log
    assert eng.state.pages_live_peak == jeng.state.pages_live_peak
    assert eng.state.pages_live == jeng.state.pages_live == 0
    assert eng.state.buf.data_ptr() == ptr
    assert eng.state.allocated_bytes == int(jeng.state.buf.nbytes)
    jleaves = jax.tree_util.tree_leaves(jeng.caches)
    for leaf, jleaf in zip(_leaves(eng.caches), jleaves, strict=True):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jleaf), rtol=1e-5,
                                   atol=1e-5)


def test_memory_report_under_paging_equals_the_jax_engine():
    jcfg, jparams, cfg, _ = _params("qwen3-0.6b")
    jeng = jax_engine_mod.InferenceEngine(jcfg, jparams, n_slots=N_SLOTS,
                                          max_len=MAX_LEN, page_size=1024)
    eng = _port("qwen3-0.6b", page_size=1024)
    fields = ("state_pages_total", "state_pages_live", "state_page_size",
              "cache_bytes_per_slot", "state_live_bytes")

    def report(e):
        rep = e.memory_report
        return {f: getattr(rep, f) for f in fields}

    assert report(eng) == report(jeng)
    for e in (eng, jeng):
        for p in _prompts(cfg, sizes=(4, 9)):
            e.submit(p, max_new_tokens=5)
        e.step()
    assert report(eng) == report(jeng)
    rep = eng.memory_report
    assert rep.state_pages_live > 0
    assert rep.state_live_bytes == rep.state_pages_live * 1024
    assert rep.cache_bytes_per_slot == rep.state_live_bytes // 2
    assert "paged state:" in rep.summary() and "ON (paged)" in rep.summary()
    # the symmetric engine keeps the fields unset
    sym = _port("qwen3-0.6b")
    assert sym.memory_report.state_pages_total is None
    assert sym.memory_report.state_page_size is None
    assert sym.page_log == []


# ------------------------------------------ against the symmetric engine


@pytest.mark.parametrize("page_size", [1024, 1000, 4096])
@pytest.mark.parametrize("arch,window", [("qwen3-0.6b", None), ("gemma3-4b", None),
                                         ("gemma3-4b", 8), ("mamba2-2.7b", None),
                                         ("zamba2-7b", None)])
def test_paged_decode_byte_identical_to_symmetric(arch, window, page_size):
    """A divisor of the slot stride, a page size that divides nothing
    (rows and leaves straddle pages), and pages larger than one leaf's
    rows. Both ring branches of ``detect_state_axes``: at ``max_len`` 64
    gemma3's window of 1024 gives rings of T = 64, which follow
    ``max_len`` and are paged by tokens; a window of 8 gives rings of 8,
    fully live. Mamba2 states are fully live; zamba2's shared K/V is
    token-paged."""
    prompts, max_new = _case(arch, window)
    sym = _port(arch, window)
    want = _run(sym, prompts, max_new)
    paged = _port(arch, window, page_size=page_size)
    assert _run(paged, prompts, max_new) == want
    assert paged.slot_log == sym.slot_log
    assert paged.state.pages_live == 0
    sp = paged.memory_report.state_plan
    if arch == "gemma3-4b":
        rings = [span for leaf, span in zip(sp.leaves, sp.token_spans)
                 if "['period'][0]" in leaf.path]
        assert len(rings) == 2
        assert all((span is None) == (window is not None) for span in rings)
    if arch != "mamba2-2.7b":
        assert paged.state.pages_live_peak < paged.state.pages_total
    _assert_byte_identical(sym, paged)
    from_page_log(paged.page_log, state_plan=sp)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "nemotron-4-340b"])
def test_paged_decode_byte_identical_on_the_other_attention_configs(arch):
    """llama4's period holds two attention layers (dense and MoE)."""
    prompts = _prompts(get_reduced(arch))
    sym = _port(arch)
    want = _run(sym, prompts)
    paged = _port(arch, page_size=1000, block_size=4)
    assert _run(paged, prompts) == want
    _assert_byte_identical(sym, paged)


@pytest.mark.parametrize("block_size", [1, 4])
def test_paged_seeded_sampling_matches_symmetric(block_size):
    kw = dict(greedy=False, temperature=0.8, top_k=20, sample_seed=3,
              block_size=block_size)
    prompts = _prompts(get_reduced("qwen3-0.6b"))
    sym = _port("qwen3-0.6b", **kw)
    want = _run(sym, prompts)
    paged = _port("qwen3-0.6b", page_size=1024, **kw)
    assert _run(paged, prompts) == want
    _assert_byte_identical(sym, paged)


def test_slot_reuse_recycles_pages_and_frees_on_retirement():
    eng = _port("qwen3-0.6b", page_size=1024)
    cfg = eng.cfg
    need = len(eng.memory_report.state_plan.pages_needed(4 + MAX_NEW))
    for p in _prompts(cfg, sizes=(4, 4, 4)):
        eng.submit(p, max_new_tokens=MAX_NEW)
    eng.step()
    assert eng.state.pages_live == 2 * need
    assert len(eng.state.slot_pages(0)) == need
    eng.run_until_done()
    assert eng.state.pages_live == 0
    # the third request took slot 0 again, and its own stale pages
    pages = {}
    for page, _, _, rid in eng.page_log:
        pages.setdefault(rid, set()).add(page)
    assert pages[2] == pages[0]


# ------------------------------------- the kernel's plain version, the write


def _jax_residency(page_size, n_slots=3, max_len=64):
    """The reference's paged plan and residency for reduced qwen3's cache,
    and the port's over the same plan (the two planners agree)."""
    jcfg = jax_get_reduced("qwen3-0.6b")
    jmodel = Model.for_config(jcfg)
    jtemplate = jax.eval_shape(lambda: jmodel.init_cache(n_slots, max_len))
    jplan = jax_plan_paged_state(
        state_records_from_pytree(jtemplate, n_slots=n_slots), n_slots=n_slots,
        max_len=max_len, page_size=page_size,
        axes=jax_detect_state_axes(jmodel.init_cache, n_slots=n_slots,
                                   max_len=max_len))
    jres = jax_paging.PagedStateResidency(jplan, jtemplate, n_slots=n_slots)
    model = DecoderModel(get_reduced("qwen3-0.6b"), "cpu")
    template = model.init_cache(n_slots, max_len, device="meta")
    plan = plan_paged_state(
        state_records_from_cache(template, n_slots=n_slots), n_slots=n_slots,
        max_len=max_len, page_size=page_size,
        axes=detect_state_axes(model.init_cache, n_slots=n_slots, max_len=max_len))
    assert plan.page_offsets == jplan.page_offsets
    return jres, PagedStateResidency(plan, template, n_slots=n_slots)


def _table(res, lengths, shuffled, seed):
    """Every slot's pages needed at its length, ascending or in a random
    physical order; 0 (the null page) past each length."""
    plan = res.paged_plan
    rng = np.random.default_rng(seed)
    phys = np.arange(1, plan.n_pages_pool + 1)
    if shuffled:
        phys = rng.permutation(phys)
    table = np.zeros((res.n_slots, plan.pages_per_slot), np.int32)
    it = iter(phys)
    for b, n in enumerate(lengths):
        for j in plan.pages_needed(n):
            table[b, j] = next(it)
    return table


def _pool(res, table, lengths, seed):
    """A seeded pool: the reference's ``pack`` of a random cache, zero at
    each slot's rows from its length on (what serving leaves there),
    through ``table`` into a zero pool; padding, unmapped bytes and the
    null page stay zero."""
    rng = np.random.default_rng(seed)
    jtemplate = jax.eval_shape(lambda: Model.for_config(
        jax_get_reduced("qwen3-0.6b")).init_cache(res.n_slots, 64))
    live = np.arange(64)[None, :] < np.asarray(lengths)[:, None]  # (B, T)

    def leaf(s):
        x = rng.normal(0, 0.5, s.shape).astype(np.float32)  # (1, B, T, KV, D)
        return jnp.asarray(np.where(live[None, :, :, None, None], x, 0.0))

    caches = jax.tree_util.tree_map(leaf, jtemplate)
    buf = res.pack(caches, jnp.zeros(res.phys_total_size, jnp.uint8),
                   jnp.asarray(table))
    assert not np.asarray(buf[:res.paged_plan.page_size]).any()
    return buf


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("page_size", [1000, 1024])
def test_flash_decode_paged_ref_matches_the_jax_oracle(page_size, shuffled):
    jres, res = _jax_residency(page_size)
    lengths = [1, 37, 64]
    table = _table(res, lengths, shuffled, seed=page_size)
    jbuf = _pool(jres, table, lengths, seed=1)
    k_path, v_path = (f"['period'][0]['attn'][{i}]" for i in (0, 1))
    _, k_off, shape, strides = res.addresses[k_path]
    _, v_off, _, _ = res.addresses[v_path]
    _, T, KV, D = shape
    G = 2
    rng = np.random.default_rng(2)
    q = rng.normal(0, 4.0, (3, KV, G, D)).astype(np.float32)
    jk, jv = jres.unpack(jbuf, jnp.asarray(table))["period"][0]["attn"]
    want = jax_flash_decode_ref(jnp.asarray(q), jk[0], jv[0],
                                jnp.asarray(lengths, jnp.int32))
    buf = tensor_from_numpy(np.asarray(jbuf), "cpu").view(torch.float32)
    args = (buf, torch.from_numpy(table), k_off, v_off, strides[1], strides[2], T,
            page_size // 4, torch.tensor(lengths, dtype=torch.int32))
    got = flash_decode_paged_ref(torch.from_numpy(q), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the op on a CPU tensor is its plain version
    assert torch.equal(flash_decode_paged(torch.from_numpy(q), *args), got)


@pytest.mark.parametrize("page_size", [1000, 1024])
def test_paged_kv_write_matches_the_reference_pack(page_size):
    """The same seeded rows written at the same positions, slot 1
    inactive and slot 2 inactive at a position whose page is unmapped:
    through the port's paged write, and through the reference's unpack,
    row update (its ``attn_decode`` write: inactive rows dropped) and
    pack. The two pools are byte-identical, null page included."""
    jres, res = _jax_residency(page_size)
    lengths = [40, 20, 10]
    table = _table(res, lengths, shuffled=True, seed=3)
    jbuf = _pool(jres, table, lengths, seed=4)
    pos = np.array([17, 5, 50], np.int32)  # slot 2's row 50 lies past its pages
    active = np.array([True, False, False])
    rng = np.random.default_rng(5)
    _, _, shape, _ = res.addresses["['period'][0]['attn'][0]"]
    _, T, KV, D = shape
    k_new = rng.normal(0, 1, (3, 1, KV, D)).astype(np.float32)
    v_new = rng.normal(0, 1, (3, 1, KV, D)).astype(np.float32)

    caches = jres.unpack(jbuf, jnp.asarray(table))
    jk, jv = caches["period"][0]["attn"]
    slot_b = jnp.where(jnp.asarray(active), jnp.minimum(jnp.asarray(pos), T - 1), T)
    rows = jnp.arange(3)
    jk = jk.at[0, rows, slot_b].set(jnp.asarray(k_new[:, 0]), mode="drop")
    jv = jv.at[0, rows, slot_b].set(jnp.asarray(v_new[:, 0]), mode="drop")
    caches = {"period": ({"attn": (jk, jv)},), "remainder": ()}
    want = np.asarray(jres.pack(caches, jbuf, jnp.asarray(table)))

    buf = tensor_from_numpy(np.asarray(jbuf), "cpu")
    bound = res.bind(buf, torch.from_numpy(table))
    k_leaf, v_leaf = (leaf[0] for leaf in bound["period"][0]["attn"])
    _write_kv_paged(k_leaf, v_leaf, torch.from_numpy(k_new), torch.from_numpy(v_new),
                    torch.clamp(torch.from_numpy(pos), max=T - 1),
                    torch.from_numpy(active))
    assert buf.numpy().tobytes() == want.tobytes()
    assert not buf[:page_size].any()


@pytest.mark.parametrize("page_size", [1000, 1024])
def test_paged_reset_matches_the_reference_reset(page_size):
    """Slot reset through the table against the reference's
    ``paged_reset_impl`` (unpack, ``reset_slots``, pack) on one seeded
    pool, slot 0 kept and slots 1 and 2 dropped: the port reads only the
    dropped slots' host table rows, and the two pools are byte-identical
    (negative values left as -0.0, the null page still zero)."""
    jres, res = _jax_residency(page_size)
    lengths = [40, 20, 64]
    table = _table(res, lengths, shuffled=True, seed=8)
    jbuf = _pool(jres, table, lengths, seed=9)
    keep = np.array([True, False, False])
    jmodel = Model.for_config(jax_get_reduced("qwen3-0.6b"))
    want = np.asarray(jax_paging.paged_reset_impl(jmodel, jres)(
        jbuf, jnp.asarray(keep), jnp.asarray(table)))
    buf = tensor_from_numpy(np.asarray(jbuf), "cpu")
    res.wipe(buf, torch.from_numpy(table), table[~keep])
    assert buf.numpy().tobytes() == want.tobytes()
    assert (want.view(np.float32) == 0).sum() > (
        np.asarray(jbuf).view(np.float32) == 0).sum()


def test_gather_is_the_reference_unpack():
    jres, res = _jax_residency(1000)
    table = _table(res, [3, 64, 0], shuffled=True, seed=6)
    jbuf = _pool(jres, table, [3, 64, 0], seed=7)
    want = jax.tree_util.tree_leaves(jres.unpack(jbuf, jnp.asarray(table)))
    got = res.gather(tensor_from_numpy(np.asarray(jbuf), "cpu"),
                     torch.from_numpy(table))
    for g, w in zip(_leaves(got), want, strict=True):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_paged_residency_checks_its_plan():
    model = DecoderModel(get_reduced("qwen3-0.6b"), "cpu")
    template = model.init_cache(2, 64, device="meta")
    records = state_records_from_cache(template, n_slots=2)
    with pytest.raises(TypeError, match="PagedStatePlan"):
        PagedStateResidency(plan_state(records, n_slots=2, max_len=64), template,
                            n_slots=2)
    odd = plan_paged_state(records, n_slots=2, max_len=64, page_size=1002)
    with pytest.raises(ValueError, match="whole"):
        PagedStateResidency(odd, template, n_slots=2)
    res = PagedStateResidency(
        plan_paged_state(records, n_slots=2, max_len=64, page_size=1024), template,
        n_slots=2)
    state = PagedResidentState(model, res, "cpu")
    assert state.buf.numel() == res.phys_total_size == (128 + 1) * 1024
    assert state.table.shape == (2, 64) and state.table.dtype == torch.int32


def test_table_is_written_in_place_at_admission_only():
    eng = _port("qwen3-0.6b", page_size=1024)
    table, ptr = eng.state.table, eng.state.table.data_ptr()
    for p in _prompts(eng.cfg, sizes=(4, 4, 4)):
        eng.submit(p, max_new_tokens=3)
    eng.run_until_done()
    assert eng.state.table is table and table.data_ptr() == ptr
    assert np.array_equal(table.numpy(), eng.state._table)
    assert eng.state.inputs["table"] is table


# ------------------------------------------- rings on the kernel's lengths


@pytest.mark.parametrize("T,window", [(1, 1), (1, 6), (1, 1024), (8, 8), (8, 13),
                                      (8, 1024), (64, 64), (64, 69), (64, 1024)])
def test_ring_mask_is_the_kernel_cores_lengths(T, window):
    """The plain decode's ring mask and the kernel core's ``lengths =
    min(pos + 1, T)`` read the same slots: on a ring of seeded values
    (slots the mask drops included), both decodes give the same output
    within 1e-6 (fp32) at every position over three wraps, per-slot
    positions apart."""
    B, KV, G, D = 3, 2, 2, 64
    gen = torch.Generator().manual_seed(T * 1000 + window)
    p = attention.attn_init(gen, (), 32, KV * G, KV, D, False, torch.float32, "cpu")
    kw = dict(n_heads=KV * G, n_kv=KV, head_dim=D, theta=10_000.0, window=window)
    rng = np.random.default_rng(T + window)
    for pos in range(3 * T + 3):
        pos_b = torch.tensor([pos, max(pos - 1, 0), pos + T // 2], dtype=torch.int32)
        x = torch.from_numpy(rng.normal(0, 1, (B, 1, 32)).astype(np.float32))
        ring = rng.normal(0, 1, (2, B, T, KV, D)).astype(np.float32)
        plain = tuple(torch.from_numpy(ring[i].copy()) for i in range(2))
        kernel = tuple(torch.from_numpy(ring[i].copy()) for i in range(2))
        want, _ = attention.attn_decode(p, x, plain, pos_b, **kw)
        got, _ = attention.attn_decode_kernel(p, x, kernel, pos_b, **kw)
        assert all(torch.equal(a, b) for a, b in zip(plain, kernel))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_a_ring_longer_than_its_window_raises():
    gen = torch.Generator().manual_seed(0)
    p = attention.attn_init(gen, (), 32, 4, 2, 64, False, torch.float32, "cpu")
    cache = (torch.zeros(1, 9, 2, 64), torch.zeros(1, 9, 2, 64))
    with pytest.raises(ValueError, match="longer than its window"):
        attention.attn_decode_kernel(p, torch.zeros(1, 1, 32), cache, 3, n_heads=4,
                                     n_kv=2, head_dim=64, theta=10_000.0, window=8)


# --------------------------------------------------------- PagedLeaf.put


def _zamba2_pool(page_size, seed):
    """Reduced zamba2's paged residency over 3 slots (conv windows, SSM
    states and the shared block's K/V), a pool of seeded values with the
    null page zero, and a shuffled table mapping slots 0 and 1 fully and
    nothing of slot 2."""
    model = DecoderModel(get_reduced("zamba2-7b"), "cpu")
    template = model.init_cache(3, 64, device="meta")
    plan = plan_paged_state(state_records_from_cache(template, n_slots=3), n_slots=3,
                            max_len=64, page_size=page_size)
    res = PagedStateResidency(plan, template, n_slots=3)
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.normal(0, 1, res.phys_total_size // 4).astype(np.float32))
    buf = buf.view(torch.uint8)
    buf[:page_size] = 0
    table = np.zeros((3, plan.pages_per_slot), np.int32)
    table[:2] = rng.permutation(np.arange(1, plan.n_pages_pool + 1))[
        :2 * plan.pages_per_slot].reshape(2, -1)
    return res, buf, torch.from_numpy(table)


def _layers(res, buf, table):
    """path -> one layer of each leaf (the leaves are stacked over one
    period)."""
    return {path: leaf[0] for path, leaf in res.leaves(buf, table).items()}


@pytest.mark.parametrize("page_size", [1000, 1024])
def test_put_of_gather_leaves_the_pool_as_it_was(page_size):
    res, buf, table = _zamba2_pool(page_size, seed=page_size)
    before = buf.clone()
    layers = _layers(res, buf, table)
    partial = 0
    for leaf in layers.values():
        runs = leaf._runs()
        partial += sum(c1 - c0 < leaf.page_elems for _, _, c0, c1 in runs)
        leaf.put(leaf.gather())
    assert partial  # some runs start or end inside a page
    assert torch.equal(buf, before)
    assert not buf[:page_size].any()


@pytest.mark.parametrize("page_size", [1000, 1024])
@pytest.mark.parametrize("path", ["['period'][0]['mamba'][0]", "['period'][1]['mamba'][1]",
                                  "['period'][1]['shared'][0]"])
def test_put_writes_its_leaf_and_no_neighbour(page_size, path):
    """A put of seeded values into one leaf (slot 2, unmapped, gets the
    zeros it gathers): only that leaf's physical elements change, the
    leaf gathers back what was put, and the null page stays zero."""
    res, buf, table = _zamba2_pool(page_size, seed=3)
    before = buf.clone()
    leaf = _layers(res, buf, table)[path]
    rng = np.random.default_rng(4)
    values = torch.from_numpy(rng.normal(0, 1, (3,) + leaf.shape).astype(np.float32))
    values[2] = 0
    leaf.put(values)
    assert torch.equal(leaf.gather(), values)
    f, f0 = buf.view(torch.float32), before.view(torch.float32)
    mine = torch.zeros(f.numel(), dtype=torch.bool)
    mine[paged_index(table[:2], leaf.offset, leaf.strides, leaf.shape,
                     leaf.page_elems).reshape(-1)] = True
    changed = f.view(torch.int32) != f0.view(torch.int32)
    assert changed.any() and not (changed & ~mine).any()
    assert not buf[:page_size].any()


# ---------------------------------------------------------- pool pressure


def test_out_of_pages_refuses_without_corruption():
    """A pool sized for one request serializes admissions: requests wait
    (head of line) and still finish with the unconstrained tokens."""
    prompts = _prompts(get_reduced("qwen3-0.6b"), sizes=(4, 4, 4, 4))
    base = _port("qwen3-0.6b", page_size=1024)
    want = _run(base, prompts)
    need = len(base.memory_report.state_plan.pages_needed(4 + MAX_NEW))
    tight = _port("qwen3-0.6b", page_size=1024, page_pool=2 * need - 1)
    assert _run(tight, prompts) == want
    assert tight.state.pages_live_peak <= 2 * need - 1
    busy = [{s for s, a, f, _ in tight.slot_log if a <= w <= f}
            for w in range(tight.waves)]
    assert all(len(s) <= 1 for s in busy), "admissions not serialized"
    assert tight.waves > base.waves
    from_page_log(tight.page_log, state_plan=tight.memory_report.state_plan)


def test_unfittable_request_raises_the_reference_error():
    eng = _port("qwen3-0.6b", page_size=1024, page_pool=1)
    eng.submit(_prompts(eng.cfg, sizes=(4,))[0], max_new_tokens=60)
    with pytest.raises(PagedOutOfPagesError, match="paged admission refused") as e:
        eng.run_until_done()
    ref = jax_paging.PagedOutOfPagesError(
        pages_needed=e.value.pages_needed, pages_free=e.value.pages_free,
        pages_live=e.value.pages_live, pages_total=e.value.pages_total)
    assert str(e.value) == str(ref)
    assert (e.value.pages_free, e.value.pages_total) == (1, 1)
    assert not eng.state.table.any(), "a refused allocation changed the table"


def test_unfinished_requests_under_pool_pressure():
    probe = _port("qwen3-0.6b", page_size=1024)
    per_slot = probe.memory_report.state_plan.pages_per_slot
    eng = _port("qwen3-0.6b", page_size=1024, page_pool=per_slot)
    for p in _prompts(eng.cfg, sizes=(4, 5)):
        eng.submit(p, max_new_tokens=10)
    with pytest.warns(RuntimeWarning, match="exhausted"):
        eng.run_until_done(max_waves=4)
    assert len(eng.unfinished_requests()) >= 1
    assert eng.state.pages_live <= per_slot


def _null_page_zero_after_every_wave(eng, prompts, budgets):
    """Serve wave by wave; under paging the null page is all zeros after
    every wave. Returns the tokens."""
    for p, n in zip(prompts, budgets):
        eng.submit(p, max_new_tokens=n)
    done = []
    while eng._active or eng._queue:
        done += eng.step()
        if eng.paged:
            assert not eng.state.buf[:eng.page_size].any(), f"wave {eng.waves}"
    return {r.request_id: list(r.tokens) for r in done}


def test_null_page_stays_zero_with_a_slot_never_admitted():
    """mamba2 from a pool of one slot's pages: admissions serialize on
    slot 0, and slot 1, never admitted, maps only the null page, which
    its state puts write back every wave."""
    prompts = _prompts(get_reduced("mamba2-2.7b"), sizes=(4, 5, 3))
    budgets = (5, 4, 6)
    want = _null_page_zero_after_every_wave(_port("mamba2-2.7b"), prompts, budgets)
    per_slot = _port("mamba2-2.7b", page_size=1000).memory_report.state_plan.pages_per_slot
    eng = _port("mamba2-2.7b", page_size=1000, page_pool=per_slot)
    assert _null_page_zero_after_every_wave(eng, prompts, budgets) == want
    assert {s for s, _, _, _ in eng.slot_log} == {0}
    assert not eng.state._table[1].any()


def test_null_page_stays_zero_under_steals():
    """zamba2 from a pool of a short and a long request's pages: the
    third request (long) waits until both retire, then takes slot 0's
    own stale pages and steals the rest from slot 1, whose cleared
    entries resolve to the null page while its rows are put back."""
    prompts = _prompts(get_reduced("zamba2-7b"), sizes=(4, 4, 4))
    budgets = (2, 40, 40)
    want = _null_page_zero_after_every_wave(_port("zamba2-7b"), prompts, budgets)
    probe = _port("zamba2-7b", page_size=1000)
    sp = probe.memory_report.state_plan
    pool = len(sp.pages_needed(6)) + len(sp.pages_needed(44))
    assert pool < 2 * sp.pages_per_slot
    eng = _port("zamba2-7b", page_size=1000, page_pool=pool)
    assert _null_page_zero_after_every_wave(eng, prompts, budgets) == want
    slots = {rid: s for s, _, _, rid in eng.slot_log}
    pages = {}
    for page, _, _, rid in eng.page_log:
        pages.setdefault(rid, set()).add(page)
    assert slots == {0: 0, 1: 1, 2: 0}
    assert pages[2] & pages[1], "no page was stolen"
    assert (eng.state._table[1] == 0).any() and eng.state._table[1].any()


# -------------------------------------------- the served step's transients


@pytest.mark.parametrize("arch", ["gemma3-4b", "zamba2-7b"])
def test_no_whole_region_gather_on_the_served_step(arch):
    """The traced step the executor runs with the kernel cores: no node
    makes a tensor as large as one layer's whole K (or V) region, ring or
    global, of all slots. The attention layers read through the table
    (``flash_decode_paged``), and a Mamba2 layer gathers only its own
    conv window and state."""
    eng = _port(arch, page_size=1000)
    regions = [math.prod(s) for path, (_, _, s, _) in eng.residency.addresses.items()
               if "['attn']" in path or "['shared']" in path]
    region = N_SLOTS * min(regions) // (eng.cfg.n_periods if eng.cfg.n_periods else 1)
    trace = eng.executor.trace
    sizes = {node.name: node.meta["val"].numel() for node in trace.produced
             if isinstance(node.meta.get("val"), torch.Tensor)}
    big = {n: k for n, k in sizes.items() if k >= region}
    assert not big, f"whole-region tensors on the step (region {region}): {big}"
    assert any("flash_decode_paged" in str(node.target) for node in trace.produced)


# --------------------------------------------------------------- the CLI


@pytest.mark.parametrize("arch", ["gemma3-4b", "mamba2-2.7b", "zamba2-7b"])
def test_serve_cli_pages_every_family(arch, capsys):
    args = ["--device", "cpu", "--arch", arch, "--requests", "3", "--slots", "2",
            "--max-len", "64", "--prompt-len", "4", "--max-new", "3"]
    stats = serve.run(args + ["--page-size", "1024"])
    out = capsys.readouterr().out
    assert stats["state_pages_live"] == 0 and stats["pages_live_peak"] > 0
    assert "paged state: pool" in out and "page audit" in out
    assert serve.run(args)["tokens_per_request"] == stats["tokens_per_request"]


def test_serve_cli_pages_on_the_cpu(capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        stats = serve.run(["--device", "cpu", "--page-size", "1024", "--requests",
                           "3", "--slots", "2", "--max-len", "64",
                           "--prompt-len", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert stats["requests"] == 3 and stats["tokens"] == 9
    assert stats["page_size"] == 1024 and stats["state_pages_live"] == 0
    assert 0 < stats["pages_live_peak"] <= stats["state_pages_total"] == 128
    assert stats["allocated_bytes"] == 129 * 1024
    assert stats["state_ptr_before"] == stats["state_ptr_after"]
    assert "paged state: pool 128 x 1024 B pages" in out and "page audit" in out
    sym = serve.run(["--device", "cpu", "--requests", "3", "--slots", "2",
                     "--max-len", "64", "--prompt-len", "4", "--max-new", "3"])
    assert sym["tokens_per_request"] == stats["tokens_per_request"]
    assert sym["page_size"] is None and sym["pages_live_peak"] is None
