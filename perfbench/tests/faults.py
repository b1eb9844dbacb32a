"""Faults planted underneath the timed path, for the tests that see the
harness's ``correct`` come out false. Each is a context manager that
patches the port for the length of one run (``pytest.MonkeyPatch``)."""

from __future__ import annotations

import contextlib

import pytest
import torch


def state_unchanged(mp: pytest.MonkeyPatch) -> None:
    """The decode step returns its state unchanged: no K/V row is written,
    and Mamba2 decode computes on a copy of its conv window and state."""
    from repro_torch.models import attention, ssm

    mp.setattr(attention, "_write_kv", lambda *a, **k: None)
    orig = ssm.mamba_decode

    def frozen(p, x, cache, **kw):
        out, _ = orig(p, x, tuple(c.clone() for c in cache), **kw)
        return out, cache

    mp.setattr(ssm, "mamba_decode", frozen)


def half_batch(mp: pytest.MonkeyPatch) -> None:
    """The decode step leaves the first half of the slots out."""
    from repro_torch.models import transformer

    orig = transformer.decode_step

    def half(params, cfg, token, caches, pos, active=None, **kw):
        B = token.shape[0]
        keep = torch.arange(B, device=token.device) >= B // 2
        active = keep if active is None else active & keep
        return orig(params, cfg, token, caches, pos, active, **kw)

    mp.setattr(transformer, "decode_step", half)


def token_altered(mp: pytest.MonkeyPatch) -> None:
    """The sampler hands out the next token id at every fifth position."""
    from repro_torch.runtime.sampling import TokenSampler

    orig = TokenSampler.advance

    def bad(self, logits, keys, tokens, pos, step_active, done, budget, eos):
        keys, nxt, new_pos, done, budget = orig(self, logits, keys, tokens, pos,
                                                step_active, done, budget, eos)
        alter = (step_active & (pos % 5 == 3))[:, None]
        nxt = torch.where(alter, (nxt + 1) % logits.shape[-1], nxt)
        return keys, nxt, new_pos, done, budget

    mp.setattr(TokenSampler, "advance", bad)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered}


@contextlib.contextmanager
def planted(name: str | None):
    with pytest.MonkeyPatch.context() as mp:
        if name is not None:
            FAULTS[name](mp)
        yield
