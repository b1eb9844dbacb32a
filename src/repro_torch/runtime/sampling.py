"""Token sampling for the serving loop — host-side and on-device.

Port of the reference's ``runtime/sampling.py``, one contract in two
halves:

* the HOST half (:func:`softmax` / :func:`host_probs`, copied from the
  reference byte for byte and held to it by
  ``tests/test_torch_sampling.py``) backs the single-wave host loop's
  numpy sampling, in float64 with an explicit renormalization;
* the DEVICE half (:class:`TokenSampler`) selects tokens inside the
  block wave (``runtime/residency.py``): greedy argmax, or a
  temperature/top-k draw, plus the per-wave stop bookkeeping (EOS /
  budget / max_len) that lets a whole block run without the host.

``jax.random`` keys have no PyTorch counterpart that a CUDA graph could
replay, so a draw here is counter-based: the uniform of vocabulary entry
``v`` for slot ``s``'s ``n``-th emission is a hash of (seed, s, n, v)
(murmur3's 32-bit finalizer, chained), and the token is the Gumbel-max
over those uniforms, which is a draw from ``softmax(logits / T)`` over
the top-k entries. A slot's key is (seed, emission index), the
counterpart of the reference's per-slot PRNG key. Nothing holds
generator state, so the draw is safe under capture and replays, and a
slot's key advances only when the slot EMITS a token: draws depend on
the emission index alone, so the sampled trajectory for a fixed seed is
invariant to the block size. The numbers differ from the reference's
``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.runtime.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """The serving loop's sampling knobs.

    ``greedy=True`` ignores (and canonicalizes away) ``temperature`` and
    ``top_k`` — they do not shape the greedy graph. ``top_k=0`` means no
    top-k filtering.
    """

    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0

    def __post_init__(self):
        if not self.greedy and self.temperature <= 0.0:
            raise ValueError(
                f"sampling temperature must be > 0, got {self.temperature}"
            )
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


def softmax(x: np.ndarray) -> np.ndarray:
    """float64 softmax with explicit renormalization.

    ``Generator.choice(p=...)`` validates ``abs(p.sum() - 1) < atol`` in
    the dtype of ``p``; a float32 softmax over a big vocab rounds past
    that tolerance often enough to raise in real runs. Promote first,
    renormalize explicitly after."""
    x = np.asarray(x, np.float64)
    e = np.exp(x - x.max())
    p = e / e.sum()
    return p / p.sum()


def host_probs(
    row: np.ndarray, *, temperature: float = 1.0, top_k: int = 0
) -> np.ndarray:
    """The host loop's sampling distribution for one logit row —
    temperature scaling + optional top-k masking, then the float64
    :func:`softmax`."""
    x = np.asarray(row, np.float64)
    if temperature != 1.0:
        x = x / temperature
    if top_k and top_k < x.size:
        kth = np.partition(x, -top_k)[-top_k]
        x = np.where(x < kth, -np.inf, x)
    return softmax(x)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32), in two 16-bit
    halves of ``c`` so that no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniforms(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """(n_slots, vocab) float32 uniforms in (0, 1): entry [s, v] hashes
    the slot's key (``keys[s] = (seed, emission index)``), s and v."""
    dev = keys.device
    slots = torch.arange(keys.shape[0], dtype=torch.int64, device=dev)
    h = fmix32((keys[:, 0] ^ 0x9E3779B9) & _M32)
    h = fmix32(h ^ slots)
    h = fmix32(h ^ (keys[:, 1] & _M32))
    v = fmix32(torch.arange(vocab, dtype=torch.int64, device=dev) ^ 0x7F4A7C15)
    bits = fmix32(h[:, None] ^ v[None, :]) >> 8  # 24 bits
    return (bits.to(torch.float32) + 0.5) * (1.0 / (1 << 24))


class TokenSampler:
    """On-device token selection + per-wave stop bookkeeping.

    One instance per engine; its knobs are fixed (a captured block wave
    bakes them in). Every method is plain torch ops on the device with
    no host sync, safe inside a captured graph."""

    def __init__(self, params: SamplingParams, *, max_len: int):
        self.params = params
        self.max_len = int(max_len)

    @staticmethod
    def init_keys(seed: int, n_slots: int, device=None) -> torch.Tensor:
        """Per-slot keys, (n_slots, 2) int64: the engine's sample seed
        and the slot's emission count, which starts at 0. ``device`` None
        is the card (``resolve_device``: it raises without one)."""
        keys = torch.zeros((n_slots, 2), dtype=torch.int64,
                           device=resolve_device(device))
        keys[:, 0] = int(seed) & _M32
        return keys

    def _draw(self, logits: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        x = logits.float() / self.params.temperature
        k = self.params.top_k
        if k and k < x.shape[-1]:
            kth = torch.topk(x, k, dim=-1).values[:, -1:]
            x = torch.where(x < kth, float("-inf"), x)
        gumbel = -torch.log(-torch.log(uniforms(keys, x.shape[-1])))
        return torch.argmax(x + gumbel, dim=-1).to(torch.int32)

    def advance(self, logits, keys, tokens, pos, step_active, done, budget,
                eos):
        """One wave of post-logits bookkeeping, entirely on the device.

        Selects the next token for every emitting slot; frozen slots
        (``~step_active``) keep their token, position, budget and key —
        a slot's key advances only on emission, so sampled trajectories
        are invariant to how waves are grouped into blocks. Folds the
        stop conditions (EOS, exhausted budget, max_len) into ``done``.
        ``eos`` is an int32 tensor; callers with no EOS pass -1 (never
        matches a vocab token). Returns ``(keys, tokens (n, 1), pos,
        done, budget)``."""
        if self.params.greedy:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            nxt = self._draw(logits, keys)
            step = torch.stack([torch.zeros_like(step_active), step_active], -1)
            keys = keys + step.to(keys.dtype)
        nxt = torch.where(step_active, nxt, tokens[:, 0])
        new_pos = pos + step_active.to(pos.dtype)
        new_budget = budget - step_active.to(budget.dtype)
        stopped = step_active & (
            (nxt == eos)
            | (new_budget <= 0)
            | (new_pos >= self.max_len - 1)
        )
        return keys, nxt[:, None], new_pos, done | stopped, new_budget
