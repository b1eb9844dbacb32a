"""The one traffic generator: a mix file's parameters and a seed give the
requests a window offers.

A length distribution is ``{"dist": "lognormal", "median", "sigma",
"min", "max"}``, ``{"dist": "uniform", "min", "max"}`` (whole numbers,
both ends in) or ``{"dist": "fixed", "value"}``. Lengths are taken at
stratified quantiles, ``(i + 0.5) / n`` for ``i < n``, so every seed
serves the same multiset of lengths; the seed sets their order, the
order of the arrival gaps and the tokens. With ``"strata": s`` the
order is balanced: the sorted values fall into ``s`` contiguous strata,
and each run of ``s`` consecutive requests takes one value of each
stratum, the strata and the values in them in an order drawn from the
seed, so that no seed bunches the longest prompts or the shortest gaps
together.

* ``"loop": "open"``: ``round(rate_per_s * seconds)`` requests, due at
  the cumulative sums of a shuffled set of exponential gaps (stratified
  quantiles of the exponential at ``rate_per_s``, scaled so that the
  window offers the rate exactly); the first is due at 0.
* ``"loop": "closed"``: ``clients`` clients, each sending its next
  request when its last one finishes. Requests come in rounds of
  ``clients``, each round one stratified multiset in a shuffled order.
  With ``"stagger": true`` the first round's output budgets are the
  stratified quantiles of the residual life of the output distribution
  (the budget a slot has left at a random moment of a steady stream), so
  completions spread over the window from its start.

Prompt tokens are uniform over the vocabulary.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np


@dataclasses.dataclass
class Offer:
    """One request as the generator offers it."""

    index: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    due_s: float | None  # open loop: seconds after the window starts


def _word(seed: int) -> int:
    """Any whole number as a 64-bit word (a seed may be negative)."""
    return int(seed) % 2**64


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator of ``seed`` for one use (``stream``)."""
    return np.random.default_rng(np.random.SeedSequence([_word(seed), int(stream)]))


def seed64(seed: int, stream: int) -> int:
    """A 63-bit seed of ``seed`` for one use, for ``torch.Generator``."""
    ss = np.random.SeedSequence([_word(seed), int(stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The lengths at the stratified quantiles ``(i + 0.5) / n``."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["dist"]
    if kind == "fixed":
        return np.full(n, int(dist["value"]), np.int64)
    lo, hi = int(dist["min"]), int(dist["max"])
    if kind == "uniform":
        x = lo + np.floor(u * (hi - lo + 1))
    elif kind == "lognormal":
        nd = statistics.NormalDist()
        z = np.array([nd.inv_cdf(float(v)) for v in u])
        x = np.rint(math.exp(math.log(dist["median"])) * np.exp(dist["sigma"] * z))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(x, lo, hi).astype(np.int64)


def residual_quantiles(dist: dict, n: int) -> np.ndarray:
    """Stratified quantiles of the residual life R of a length L drawn
    from ``dist``: P(R = r) is proportional to P(L >= r), r >= 1."""
    support = quantiles(dist, 4096)  # the distribution, finely stratified
    hi = int(support.max())
    r = np.arange(1, hi + 1)
    survival = 1.0 - np.searchsorted(np.sort(support), r, side="left") / len(support)
    cdf = np.cumsum(survival) / survival.sum()
    u = (np.arange(n) + 0.5) / n
    return r[np.minimum(np.searchsorted(cdf, u, side="left"), hi - 1)]


def balanced(values: np.ndarray, strata: int, rng: np.random.Generator) -> np.ndarray:
    """``values`` in an order drawn from ``rng``; with ``strata > 1``
    each run of ``strata`` consecutive places takes one value of each of
    ``strata`` contiguous strata of the sorted values."""
    if strata <= 1:
        return rng.permutation(values)
    groups = [list(rng.permutation(g)) for g in np.array_split(np.sort(values), strata)]
    out: list = []
    while len(out) < len(values):
        for gi in rng.permutation(strata):
            if groups[gi]:
                out.append(groups[gi].pop())
    return np.array(out, dtype=np.asarray(values).dtype)


def _prompt(rng: np.random.Generator, length: int, vocab: int) -> np.ndarray:
    return rng.integers(0, vocab, size=int(length)).astype(np.int32)


def open_loop(mix: dict, seed: int, seconds: float, vocab: int) -> list[Offer]:
    rate = float(mix["rate_per_s"])
    n = max(int(round(rate * seconds)), 1)
    rng = rng_for(seed, 1)
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    gaps *= (n / rate) / gaps.sum()
    strata = int(mix.get("strata", 1))
    gaps = balanced(gaps, strata, rng)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    prompts = balanced(quantiles(mix["prompt"], n), strata, rng)
    outputs = balanced(quantiles(mix["output"], n), strata, rng)
    tok = rng_for(seed, 2)
    return [Offer(i, _prompt(tok, prompts[i], vocab), int(outputs[i]), float(due[i]))
            for i in range(n)]


class ClosedLoop:
    """The requests of a closed loop, round by round; ``next()`` gives
    the next one to send."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.vocab = mix, vocab
        self.clients = int(mix["clients"])
        self._order = rng_for(seed, 1)
        self._tokens = rng_for(seed, 2)
        self._round: list[Offer] = []
        self._index = 0
        self._rounds = 0

    def _next_round(self) -> None:
        c = self.clients
        prompts = self._order.permutation(quantiles(self.mix["prompt"], c))
        if self._rounds == 0 and self.mix.get("stagger"):
            outputs = residual_quantiles(self.mix["output"], c)
        else:
            outputs = quantiles(self.mix["output"], c)
        outputs = self._order.permutation(outputs)
        self._round = [
            Offer(self._index + i, _prompt(self._tokens, prompts[i], self.vocab),
                  int(outputs[i]), None)
            for i in range(c)
        ]
        self._index += c
        self._rounds += 1

    def next(self) -> Offer:
        if not self._round:
            self._next_round()
        return self._round.pop(0)


def warmup_offers(seed: int, vocab: int, n: int, prompt_len: int,
                  max_new: int) -> list[Offer]:
    """Requests that only warm the engine up before the window."""
    rng = rng_for(seed, 3)
    return [Offer(-1 - i, _prompt(rng, prompt_len, vocab), max_new, None)
            for i in range(n)]
