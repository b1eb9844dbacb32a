"""Config-driven dense decoder: params, caches and the decode step.

Port of the decode path of the reference's ``models/transformer.py`` for
layers with global attention and an MLP (the other mixers come with
later slices and raise ``NotImplementedError``).

The layer program is ``period × n_periods + remainder``. Period params
and caches are stacked on a leading ``n_periods`` axis, as in the
reference; the reference scans that axis with ``lax.scan``, the port
runs a Python loop over it and reads layer i as a view of the stack.

Caches mirror the reference's structure —
``{"period": ({"attn": (k, v)}, ...), "remainder": (...)}`` with period
leaves ``(n_periods, B, T, KV, hd)`` — and are updated IN PLACE by the
decode step (see ``models/attention.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn
from repro_torch.models.layers import init_rms, mlp_apply, mlp_init, rms_norm

ATTENTION = {"kernel": attn.attn_decode_kernel, "plain": attn.attn_decode}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_spec(spec: LayerSpec) -> None:
    if spec.mixer != "attn" or spec.ffn != "mlp" or spec.shared_attn:
        raise NotImplementedError(
            f"layer {spec}: the port serves attention + MLP layers; other "
            f"mixers come with their slices (ROADMAP A8)"
        )


# --------------------------------------------------------------- init


def _layer_init(generator, lead, cfg: ArchConfig, spec: LayerSpec, device) -> dict:
    _check_spec(spec)
    dtype = _dtype(cfg)
    return {
        "ln1": init_rms(cfg.d_model, device, lead),
        "ln2": init_rms(cfg.d_model, device, lead),
        "attn": attn.attn_init(
            generator, lead, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.qk_norm, dtype, device,
        ),
        "mlp": mlp_init(generator, lead, cfg.d_model, cfg.d_ff, cfg.act,
                        dtype, device),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator, device) -> dict:
    """Random params with the reference's distributions
    (``transformer.py:87-114``): embed N(0,1)/√d_model, linears
    U(±1/√d_in), rms scales zero. Draws run on the generator's device and
    land on ``device``. The numbers differ from the reference's
    ``jax.random`` draws; ``bridge.params_from_numpy`` brings the
    reference's own params over when the two must agree."""
    dtype = _dtype(cfg)
    emb = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                      dtype=torch.float32, device=generator.device)
    params: dict[str, Any] = {
        "embed": (emb * (1.0 / np.sqrt(cfg.d_model))).to(device=device, dtype=dtype),
        "ln_f": init_rms(cfg.d_model, device),
    }
    del emb
    params["period"] = tuple(
        _layer_init(generator, (cfg.n_periods,), cfg, spec, device)
        for spec in cfg.period
    )
    params["remainder"] = tuple(
        _layer_init(generator, (), cfg, spec, device) for spec in cfg.remainder
    )
    return params


def _empty_cache_for_spec(spec, cfg, lead, batch, cache_len, dtype, device) -> dict:
    _check_spec(spec)
    T = min(spec.window, cache_len) if spec.window else cache_len
    shape = (*lead, batch, T, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "attn": (
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )
    }


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, device) -> dict:
    """Zeroed decode caches; period leaves stacked over n_periods
    (``device="meta"`` gives the shape-only template)."""
    dtype = _dtype(cfg)
    return {
        "period": tuple(
            _empty_cache_for_spec(spec, cfg, (cfg.n_periods,), batch,
                                  cache_len, dtype, device)
            for spec in cfg.period
        ),
        "remainder": tuple(
            _empty_cache_for_spec(spec, cfg, (), batch, cache_len, dtype, device)
            for spec in cfg.remainder
        ),
    }


# --------------------------------------------------------------- decode


def _block(p, spec, cfg, h, cache, pos, active, rope_freqs, attention):
    x = rms_norm(h, p["ln1"], cfg.rms_eps)
    a, _ = ATTENTION[attention](
        p["attn"], x, cache["attn"], pos,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
        window=spec.window, eps=cfg.rms_eps, active=active,
        rope_freqs=rope_freqs,
    )
    h = h + a
    return h + mlp_apply(p["mlp"], rms_norm(h, p["ln2"], cfg.rms_eps), cfg.act)


def _layer(tree: Any, i: int) -> Any:
    """Layer i of a stacked (n_periods, ...) param or cache structure."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_layer(v, i) for v in tree)
    return tree[i]


def decode_step(
    params: dict,
    cfg: ArchConfig,
    token: torch.Tensor,  # (B, 1) integer
    caches: dict,
    pos: torch.Tensor,  # (B,) int32 per-slot positions
    active: torch.Tensor | None = None,  # (B,) bool continuous-batching mask
    *,
    rope_freqs: torch.Tensor | None = None,
    attention: str = "kernel",
) -> tuple[torch.Tensor, dict]:
    """ONE new token against the caches. Returns (logits (B, vocab),
    caches) — the caches are the ones passed in, written in place.
    ``attention`` picks the attention core: ``"kernel"`` (the served
    path, ``repro_torch::flash_decode``) or ``"plain"`` (parity checks)."""
    h = params["embed"][token]
    for i in range(cfg.n_periods):
        for j, spec in enumerate(cfg.period):
            h = _block(_layer(params["period"][j], i), spec, cfg, h,
                       _layer(caches["period"][j], i), pos, active,
                       rope_freqs, attention)
    for j, spec in enumerate(cfg.remainder):
        h = _block(params["remainder"][j], spec, cfg, h,
                   caches["remainder"][j], pos, active, rope_freqs, attention)
    h = rms_norm(h, params["ln_f"], cfg.rms_eps)
    logits = h @ params["embed"].T
    return logits[:, 0], caches


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def reset_slots(caches: dict, keep: torch.Tensor) -> dict:
    """Zero cache rows where ``keep[b]`` is False, in place (slot
    recycling). Period caches carry batch on axis 1 (after the n_periods
    axis), remainder caches on axis 0."""

    def mask(leaf, axis):
        shape = [1] * leaf.dim()
        shape[axis] = leaf.shape[axis]
        leaf.mul_(keep.to(leaf.dtype).reshape(shape))

    for leaf in _leaves(caches["period"]):
        mask(leaf, 1)
    for leaf in _leaves(caches["remainder"]):
        mask(leaf, 0)
    return caches
