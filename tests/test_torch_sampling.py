"""The port's ``runtime/sampling.py`` against ``repro.runtime.sampling``.

The host half is the reference's source, byte for byte. The device
half's greedy ``TokenSampler.advance`` must give the reference's tokens,
positions, stop flags and budgets on the same numpy inputs. Its draws
cannot give ``jax.random``'s numbers; they are held to what they
promise instead: reproducible from the seed, frozen slots untouched,
and the frequencies of a few thousand draws within a chi-squared bound
of ``host_probs``.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro.runtime import sampling as jax_sampling  # noqa: E402
from repro_torch.runtime import sampling  # noqa: E402


@pytest.mark.parametrize("name", ["SamplingParams", "softmax", "host_probs"])
def test_host_half_is_the_reference_copy(name):
    assert inspect.getsource(getattr(sampling, name)) == inspect.getsource(
        getattr(jax_sampling, name))


def _inputs(seed, n=6, vocab=40):
    rng = np.random.default_rng(seed)
    return dict(
        logits=rng.standard_normal((n, vocab)).astype(np.float32),
        tokens=rng.integers(0, vocab, (n, 1)).astype(np.int32),
        pos=np.array([0, 3, 60, 62, 10, 5][:n], np.int32),
        step_active=np.array([1, 1, 1, 0, 1, 1][:n], bool),
        done=np.array([0, 0, 0, 0, 1, 0][:n], bool),
        budget=np.array([5, 1, 9, 4, 2, 3][:n], np.int32),
    )


def _torch(inp):
    return {k: torch.from_numpy(v.copy()) for k, v in inp.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("eos", [-1, "hit"])
def test_greedy_advance_equals_the_reference(seed, eos):
    inp = _inputs(seed)
    if eos == "hit":  # the argmax of slot 0, so its stop comes from EOS
        eos = int(inp["logits"][0].argmax())
    params = dict(max_len=64)
    jkeys = jax_sampling.TokenSampler.init_keys(0, 6)
    want = jax_sampling.TokenSampler(jax_sampling.SamplingParams(), **params).advance(
        jnp.asarray(inp["logits"]), jkeys, jnp.asarray(inp["tokens"]),
        jnp.asarray(inp["pos"]), jnp.asarray(inp["step_active"]),
        jnp.asarray(inp["done"]), jnp.asarray(inp["budget"]), jnp.int32(eos))
    t = _torch(inp)
    keys = sampling.TokenSampler.init_keys(0, 6)
    got = sampling.TokenSampler(sampling.SamplingParams(), **params).advance(
        t["logits"], keys, t["tokens"], t["pos"], t["step_active"], t["done"],
        t["budget"], torch.tensor(eos, dtype=torch.int32))
    assert torch.equal(got[0], keys)  # greedy leaves the keys alone
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert g.dtype == {np.dtype("int32"): torch.int32,
                           np.dtype("bool"): torch.bool}[np.asarray(w).dtype]


@pytest.mark.parametrize("greedy", [True, False])
def test_frozen_slots_keep_everything(greedy):
    inp = _inputs(3)
    t = _torch(inp)
    sp = sampling.SamplingParams(greedy=greedy, temperature=0.7, top_k=5)
    keys = sampling.TokenSampler.init_keys(11, 6)
    keys[:, 1] = torch.arange(6) * 3  # slots at different emission counts
    got_keys, tok, pos, done, budget = sampling.TokenSampler(sp, max_len=64).advance(
        t["logits"], keys.clone(), t["tokens"], t["pos"], t["step_active"],
        t["done"], t["budget"], torch.tensor(-1, dtype=torch.int32))
    frozen = ~t["step_active"]
    assert torch.equal(tok[frozen], t["tokens"][frozen])
    assert torch.equal(pos[frozen], t["pos"][frozen])
    assert torch.equal(budget[frozen], t["budget"][frozen])
    assert torch.equal(done[frozen], t["done"][frozen])
    assert torch.equal(got_keys[frozen], keys[frozen])
    act = t["step_active"]
    assert torch.equal(pos[act], t["pos"][act] + 1)
    assert torch.equal(budget[act], t["budget"][act] - 1)
    # a key advances by one emission, and only where the slot emitted
    step = 0 if greedy else 1
    assert torch.equal(got_keys[act, 1], keys[act, 1] + step)
    assert torch.equal(got_keys[:, 0], keys[:, 0])


def test_draws_are_reproducible_and_depend_on_seed_slot_and_emission():
    logits = torch.zeros((4, 32))
    keys = sampling.TokenSampler.init_keys(5, 4)
    u1 = sampling.uniforms(keys, 32)
    assert torch.equal(u1, sampling.uniforms(keys.clone(), 32))
    assert bool(((u1 > 0) & (u1 < 1)).all())
    assert not torch.equal(u1[0], u1[1])  # slots differ
    other = keys.clone()
    other[:, 1] += 1
    assert not torch.equal(u1, sampling.uniforms(other, 32))  # emissions differ
    assert not torch.equal(u1, sampling.uniforms(
        sampling.TokenSampler.init_keys(6, 4), 32))  # seeds differ
    sampler = sampling.TokenSampler(
        sampling.SamplingParams(greedy=False), max_len=64)
    a = sampler._draw(logits, keys)
    assert torch.equal(a, sampler._draw(logits, keys.clone()))


def test_fmix32_is_murmur3s_finalizer():
    def ref(h):
        h ^= h >> 16
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        return h ^ (h >> 16)

    xs = [0, 1, 2, 0x9E3779B9, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 123456789]
    got = sampling.fmix32(torch.tensor(xs, dtype=torch.int64))
    assert got.tolist() == [ref(x) for x in xs]


# (temperature, top_k): plain, sharpened, flattened, and top-k filtered
DRAWS = [(1.0, 0), (0.5, 0), (2.0, 0), (1.0, 6)]


def _chi2_ok(draws, p):
    """The chi-squared statistic of the draws' counts against ``p`` is
    under its 0.999 quantile, and nothing is drawn where p is 0."""
    support = p > 0
    counts = np.bincount(draws, minlength=p.size)
    assert counts[~support].sum() == 0
    expected = p[support] * len(draws)
    chi2 = float(((counts[support] - expected) ** 2 / expected).sum())
    bound = float(stats.chi2.ppf(0.999, df=int(support.sum()) - 1))
    assert chi2 < bound, (chi2, bound, counts, expected)


@pytest.mark.parametrize("temperature,top_k", DRAWS)
def test_draw_frequencies_follow_host_probs(temperature, top_k):
    """Draws over a 12-entry vocabulary against ``host_probs`` of the
    same row: 4000 slots drawing once each, and one slot drawing 1500
    times through ``advance`` (its key advancing per emission). Seeds
    are fixed, so the test is deterministic; a biased draw (argmax
    without the Gumbel noise, or the noise on the wrong scale) lands far
    above the bound."""
    vocab = 12
    row = np.random.default_rng(7).standard_normal(vocab).astype(np.float32) * 1.5
    p = sampling.host_probs(row, temperature=temperature, top_k=top_k)
    sampler = sampling.TokenSampler(
        sampling.SamplingParams(greedy=False, temperature=temperature, top_k=top_k),
        max_len=10**6)
    n = 4000
    logits = torch.from_numpy(row)[None].expand(n, vocab)
    across = sampler._draw(logits, sampling.TokenSampler.init_keys(2024, n))
    _chi2_ok(across.numpy(), p)
    keys = sampling.TokenSampler.init_keys(99, 1)
    tok, pos = torch.zeros((1, 1), dtype=torch.int32), torch.zeros(1, dtype=torch.int32)
    on, off = torch.ones(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool)
    budget, eos = torch.full((1,), 10**6, dtype=torch.int32), torch.tensor(-1)
    along = []
    for _ in range(1500):
        keys, tok, pos, _, budget = sampler.advance(
            torch.from_numpy(row)[None], keys, tok, pos, on, off, budget, eos)
        along.append(int(tok[0, 0]))
    assert int(keys[0, 1]) == 1500
    _chi2_ok(np.array(along), p)
