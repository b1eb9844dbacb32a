"""The port's layers, attention and decode step against ``repro.models``.

Reduced qwen3 in float32, params made by the reference's
``init_params`` and bridged through numpy; inputs from a numpy seed.
Both attention cores of the port are checked: the plain one and the
kernel-backed one (on the CPU its op runs the plain ``flash_decode_ref``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_reduced as jax_get_reduced  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.api import Model  # noqa: E402
from repro_torch.bridge import cache_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.models import attention, layers, transformer  # noqa: E402

ARCH = "qwen3-0.6b"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    jparams = Model.for_config(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_numpy(cfg, _np_tree(jparams), "cpu")


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64), np.float32)
    scale = rng.standard_normal(64, np.float32) * 0.1
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           jax_layers.rms_norm(x, scale, 1e-6), 1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 64), np.float32)
    positions = rng.integers(0, 4096, size=(2, 3)).astype(np.int32)
    want = jax_layers.rope(x, positions, theta)
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(positions), theta)
    _close(got, want, 1e-5)


def test_mlp_apply():
    rng = np.random.default_rng(2)
    d, f = 32, 80
    p = {k: rng.standard_normal(s, np.float32) * 0.2
         for k, s in (("w_in", (d, f)), ("w_gate", (d, f)), ("w_out", (f, d)))}
    x = rng.standard_normal((2, 1, d), np.float32)
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), "silu")
    _close(got, jax_layers.mlp_apply(p, x, "silu"), 1e-5)


@pytest.mark.parametrize("core", ["plain", "kernel"])
def test_attention_decode_matches_reference(setup, core):
    jcfg, cfg, jparams, params = setup
    rng = np.random.default_rng(3)
    B, T = 3, 16
    p_j = jax.tree_util.tree_map(lambda a: a[0], jparams["period"][0]["attn"])
    p_t = {k: v[0] for k, v in params["period"][0]["attn"].items()}
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta, window=None,
              eps=cfg.rms_eps)
    x = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    k0 = rng.standard_normal((B, T, cfg.n_kv_heads, cfg.resolved_head_dim), np.float32)
    v0 = rng.standard_normal(k0.shape, np.float32)
    pos = np.array([0, 5, 20], np.int32)  # 20 >= T: clamped slot, full length
    active = np.array([True, False, True])
    out_j, (kj, vj) = jax_attn.attn_decode(
        p_j, jnp.asarray(x), (jnp.asarray(k0), jnp.asarray(v0)), jnp.asarray(pos),
        active=jnp.asarray(active), **kw,
    )
    kt, vt = torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy())
    fn = attention.attn_decode if core == "plain" else attention.attn_decode_kernel
    out_t, _ = fn(p_t, torch.from_numpy(x), (kt, vt), torch.from_numpy(pos),
                  active=torch.from_numpy(active), **kw)
    _close(out_t, out_j, 1e-5)
    _close(kt, kj, 1e-5)
    _close(vt, vj, 1e-5)
    # the inactive row is bit-unchanged
    assert np.array_equal(kt[1].numpy(), k0[1]) and np.array_equal(vt[1].numpy(), v0[1])


@pytest.mark.parametrize("core", ["plain", "kernel"])
def test_decode_step_matches_reference(setup, core):
    jcfg, cfg, jparams, params = setup
    model = Model.for_config(jcfg)
    B, T = 3, 16
    jcache = model.init_cache(B, T)
    cache = cache_from_numpy(cfg, _np_tree(jcache), "cpu")
    decode = jax.jit(lambda p, t, c, pos, a: model.decode_step(p, t, c, pos, active=a))
    rng = np.random.default_rng(4)
    pos = np.zeros(B, np.int32)
    masks = [[1, 1, 1], [1, 0, 1], [0, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 1]]
    for step, mask in enumerate(masks):
        tok = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
        active = np.array(mask, bool)
        before = [leaf.clone() for leaf in cache["period"][0]["attn"]]
        lj, jcache = decode(jparams, jnp.asarray(tok), jcache, jnp.asarray(pos),
                            jnp.asarray(active))
        lt, cache = transformer.decode_step(
            params, cfg, torch.from_numpy(tok), cache, torch.from_numpy(pos),
            torch.from_numpy(active), cores=core,
        )
        _close(lt, lj, 1e-4)
        for got, want in zip(cache["period"][0]["attn"], jcache["period"][0]["attn"]):
            _close(got, want, 1e-5)
        for old, new in zip(before, cache["period"][0]["attn"]):
            # inactive rows (batch axis 1 of the stacked leaf) bit-unchanged
            assert torch.equal(old[:, ~torch.from_numpy(active)],
                               new[:, ~torch.from_numpy(active)]), step
        pos = pos + active.astype(np.int32)


def test_reset_slots_zeroes_only_dropped_rows(setup):
    _, cfg, _, _ = setup
    cache = transformer.init_cache(cfg, 3, 8, "cpu")
    for leaf in cache["period"][0]["attn"]:
        leaf.normal_()
    keep = torch.tensor([True, False, True])
    kept = [leaf[:, keep].clone() for leaf in cache["period"][0]["attn"]]
    out = transformer.reset_slots(cache, keep)
    assert out is cache
    for leaf, k in zip(cache["period"][0]["attn"], kept):
        assert torch.equal(leaf[:, keep], k)
        assert not leaf[:, 1].any()
