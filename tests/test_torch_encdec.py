"""The enc-dec family (seamless-m4t-medium): the port's ``models/encdec.py``
and ``models/api.EncDecModel`` against ``repro.models``.

Reduced seamless (fp32: d_model 256, 4 heads of 64 over 2 KV heads, 2
encoder layers, 1 decoder layer; frames at seq_len // 4), the reference's
params bridged through numpy, tokens and frame embeddings from numpy
seeds:
* ``forward`` (teacher-forced logits, aux 0), ``prefill`` (last logits,
  the self and cross caches) and ``decode_step`` after prefill against
  the reference's;
* decode after prefill reproduces the teacher-forced forward, as
  ``tests/test_arch_smoke.py`` checks the reference;
* ``cross_attn`` and ``encode_kv`` against the reference's;
* ``for_config``, ``init_cache`` (enc_len = cache_len // enc_len_ratio),
  ``reset_slots`` on axis 1, ``remat``, and the engine refusing audio as
  the reference's does.
Tolerances: logits and caches 1e-4 (fp32 summation order over a few
layers), as ``test_torch_hybrid.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.configs.base import get_config, get_reduced  # noqa: E402
from repro_torch.launch.roofline import count_params  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.api import (FAMILIES, DecoderModel, EncDecModel,  # noqa: E402
                                    for_config)
from repro_torch.runtime.engine import InferenceEngine  # noqa: E402
from repro_torch.tree_util import from_leaves, leaves  # noqa: E402

ARCH = "seamless-m4t-medium"
S, B = 24, 2
TOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    jmodel = Model.for_config(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, _np_tree(jparams), "cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = (rng.standard_normal((B, S // cfg.enc_len_ratio, cfg.d_model)) * 0.5
              ).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    batch = {"tokens": torch.from_numpy(tokens), "frames": torch.from_numpy(frames)}
    return cfg, jmodel, jparams, for_config(cfg, "cpu"), params, jbatch, batch


def test_forward_matches_the_reference(setup):
    cfg, jmodel, jparams, model, params, jbatch, batch = setup
    want, jaux = jax.jit(lambda p, b: jmodel.forward(p, b))(jparams, jbatch)
    got, aux = model.forward(params, batch)
    assert got.shape == (B, S, cfg.vocab)
    _close(got, want)
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0


def test_prefill_and_decode_match_the_reference(setup):
    """prefill's last logits and caches, then 3 decode steps (logits and
    the self caches written in place) against the reference's."""
    cfg, jmodel, jparams, model, params, jbatch, batch = setup
    n = S - 3
    jpre = {**jbatch, "tokens": jbatch["tokens"][:, :n]}
    want, jcaches = jax.jit(lambda p, b: jmodel.prefill(p, b))(jparams, jpre)
    got, caches = model.prefill(params, {**batch, "tokens": batch["tokens"][:, :n]})
    _close(got, want)
    for part in ("self", "cross"):
        for g, w in zip(caches[part], jcaches[part]):
            assert g.shape == w.shape
            _close(g, w, 1e-5)
    # both caches grown to S positions, then decode the remaining tokens
    pad = ((0, 0), (0, 0), (0, S - n), (0, 0), (0, 0))
    jcaches = {"self": tuple(jnp.pad(c, pad) for c in jcaches["self"]),
               "cross": jcaches["cross"]}
    caches = {"self": tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, S - n))
                            for c in caches["self"]), "cross": caches["cross"]}
    jdecode = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, t, c, pos))
    for i in range(n, S):
        want, jcaches = jdecode(jparams, jbatch["tokens"][:, i:i + 1], jcaches,
                                jnp.asarray(i, jnp.int32))
        got, caches = model.decode_step(params, batch["tokens"][:, i:i + 1], caches, i)
        _close(got, want)
        for g, w in zip(caches["self"], jcaches["self"]):
            _close(g, w, 1e-5)


@pytest.mark.parametrize("cores", ["kernel", "plain"])
def test_decode_after_prefill_reproduces_forward(setup, cores):
    """decode_step(t) after prefill(t[:n]) gives the teacher-forced
    forward's logits (the reference's own check, test_arch_smoke.py), on
    both attention cores."""
    cfg, _, _, _, params, _, batch = setup
    model = EncDecModel(cfg, "cpu", cores=cores)
    full, _ = model.forward(params, batch)
    n = S - 4
    last, caches = model.prefill(params, {**batch, "tokens": batch["tokens"][:, :n]})
    torch.testing.assert_close(last, full[:, n - 1], rtol=2e-4, atol=2e-4)
    caches["self"] = tuple(torch.nn.functional.pad(c, (0, 0, 0, 0, 0, S - n))
                           for c in caches["self"])
    for i in range(n, S):
        logits, caches = model.decode_step(params, batch["tokens"][:, i:i + 1], caches,
                                           torch.full((B,), i, dtype=torch.int32))
        torch.testing.assert_close(logits, full[:, i], rtol=2e-4, atol=2e-4)


def test_cross_attention_matches_the_reference():
    rng = np.random.default_rng(1)
    d, H, KV, hd, T = 32, 4, 2, 8, 5
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.3
         for k, s in (("wq", (d, H * hd)), ("wk", (d, KV * hd)), ("wv", (d, KV * hd)),
                      ("wo", (H * hd, d)))}
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    enc = rng.standard_normal((2, T, d)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jkv = jax_attn.encode_kv(jp, jnp.asarray(enc), KV, hd)
    kv = attn.encode_kv(tp, torch.from_numpy(enc), KV, hd)
    for g, w in zip(kv, jkv):
        _close(g, w, 1e-5)
    want = jax_attn.cross_attn(jp, jnp.asarray(x), jkv, n_heads=H, head_dim=hd)
    _close(attn.cross_attn(tp, torch.from_numpy(x), kv, n_heads=H, head_dim=hd), want,
           1e-5)


def test_remat_gives_the_same_gradients(setup):
    cfg, _, _, model, params, _, batch = setup
    grads = []
    for remat in (False, True):
        live = [t.detach().clone().requires_grad_() for t in leaves(params)]
        logits, _ = model.forward(from_leaves(params, live), batch, remat=remat)
        grads.append(torch.autograd.grad(logits.square().mean(), live, allow_unused=True,
                                         materialize_grads=True))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_model_api_and_caches(setup):
    cfg, *_ = setup
    assert "audio" in FAMILIES
    assert isinstance(for_config(cfg, "cpu"), EncDecModel)
    assert isinstance(for_config(get_reduced("qwen3-0.6b"), "cpu"), DecoderModel)
    with pytest.raises(NotImplementedError):
        DecoderModel(cfg, "cpu")
    model = EncDecModel(cfg, "cpu")
    caches = model.init_cache(3, 9)
    hd = cfg.resolved_head_dim
    assert [c.shape for c in caches["self"]] == [(cfg.n_layers, 3, 9, cfg.n_kv_heads, hd)] * 2
    assert [c.shape for c in caches["cross"]] == [(cfg.n_layers, 3, 2, cfg.n_kv_heads, hd)] * 2
    assert model.init_cache(1, 3)["cross"][0].shape[2] == 1  # max(3 // 4, 1)
    for c in (*caches["self"], *caches["cross"]):
        c.fill_(1.0)
    model.reset_slots(caches, torch.tensor([True, False, True]))
    for c in (*caches["self"], *caches["cross"]):
        assert float(c[:, 1].abs().sum()) == 0 and bool((c[:, [0, 2]] == 1).all())


def test_full_width_parameter_count():
    """The full config's tree on ``meta``: the reference's count
    (``count_params``, 715,339,776) and the 63,488 norm scales it leaves
    out (2 per encoder layer, 3 per decoder layer, ln_f and ln_enc)."""
    cfg = get_config(ARCH)
    params = encdec.init_params(cfg, None, "meta")
    assert count_params(cfg) == 715_339_776
    norms = (2 * cfg.encoder_layers + 3 * cfg.n_layers + 2) * cfg.d_model
    assert sum(t.numel() for t in leaves(params)) == 715_339_776 + norms


def test_the_engine_refuses_audio(setup):
    cfg, *_, params, _, _ = setup
    with pytest.raises(NotImplementedError, match="engine drives decoder-only archs"):
        InferenceEngine(cfg, params, n_slots=2, max_len=16, device="cpu")


def test_bridge_checks_the_enc_dec_stacks(setup):
    cfg, _, jparams, *_ = setup
    tree = _np_tree(jparams)
    tree["enc"] = jax.tree_util.tree_map(lambda a: a[:1], tree["enc"])
    with pytest.raises(ValueError, match="stacked"):
        params_from_numpy(cfg, tree, "cpu")
    assert tensor_from_numpy(np.zeros(2, np.float32), "cpu").shape == (2,)
