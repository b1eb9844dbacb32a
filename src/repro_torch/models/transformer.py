"""Config-driven decoder stack: params, caches, prefill, forward and the
decode step.

Port of the reference's ``models/transformer.py`` for two layer specs:
global attention + MLP (decode only; attention prefill is ROADMAP A9) and
Mamba2 with no FFN (prefill, forward and decode). Other mixers come with
later slices and raise ``NotImplementedError``.

The layer program is ``period × n_periods + remainder``. Period params
and caches are stacked on a leading ``n_periods`` axis, as in the
reference; the reference scans that axis with ``lax.scan``, the port
runs a Python loop over it and reads layer i as a view of the stack.

Caches mirror the reference's structure —
``{"period": ({"attn": (k, v)} or {"mamba": (conv, ssm)}, ...),
"remainder": (...)}`` with period leaves ``(n_periods, B, T, KV, hd)``,
``(n_periods, B, conv-1, conv_dim)`` and ``(n_periods, B, H, P, N)`` —
and are updated IN PLACE by the decode step (see ``models/attention.py``
and ``models/ssm.py``). ``prefill`` returns new caches, stacked the same
way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import init_rms, mlp_apply, mlp_init, rms_norm

# the cores of the layers: "kernel" (the served path, the repro_torch ops
# flash_decode and ssd_chunk) or "plain" (their plain versions, for parity
# checks on the card)
CORES = ("kernel", "plain")
ATTENTION = {"kernel": attn.attn_decode_kernel, "plain": attn.attn_decode}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# the layer specs the port builds: (mixer, ffn)
PORTED_SPECS = (("attn", "mlp"), ("mamba", "none"))


def _check_spec(spec: LayerSpec) -> None:
    if (spec.mixer, spec.ffn) not in PORTED_SPECS or spec.shared_attn:
        raise NotImplementedError(
            f"layer {spec}: the port builds attention + MLP and Mamba2 "
            f"layers; other mixers come with their slices (ROADMAP A8)"
        )


# --------------------------------------------------------------- init


def _layer_init(generator, lead, cfg: ArchConfig, spec: LayerSpec, device) -> dict:
    _check_spec(spec)
    dtype = _dtype(cfg)
    # every layer has ln2, as in the reference (unused without an FFN)
    p: dict[str, Any] = {
        "ln1": init_rms(cfg.d_model, device, lead),
        "ln2": init_rms(cfg.d_model, device, lead),
    }
    if spec.mixer == "attn":
        p["attn"] = attn.attn_init(
            generator, lead, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.qk_norm, dtype, device,
        )
    else:
        p["mamba"] = ssm_mod.mamba_init(
            generator, lead, cfg.d_model, expand=cfg.ssm_expand,
            head_dim=cfg.ssm_head_dim, ngroups=cfg.ssm_groups,
            dstate=cfg.ssm_state, conv=cfg.ssm_conv, dtype=dtype, device=device,
        )
    if spec.ffn == "mlp":
        p["mlp"] = mlp_init(generator, lead, cfg.d_model, cfg.d_ff, cfg.act,
                            dtype, device)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator, device) -> dict:
    """Random params with the reference's distributions
    (``transformer.py:87-114``): embed N(0,1)/√d_model, linears
    U(±1/√d_in), rms scales zero; Mamba2 as in ``ssm.mamba_init``. Draws
    run on the generator's device and land on ``device``; on ``"meta"``
    nothing is drawn (a shape-only template for tracing). The numbers
    differ from the reference's ``jax.random`` draws;
    ``bridge.params_from_numpy`` brings the reference's own params over
    when the two must agree."""
    dtype = _dtype(cfg)
    if torch.device(device).type == "meta":
        embed = torch.empty((cfg.vocab, cfg.d_model), dtype=dtype, device=device)
    else:
        emb = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                          dtype=torch.float32, device=generator.device)
        embed = (emb * (1.0 / np.sqrt(cfg.d_model))).to(device=device, dtype=dtype)
        del emb
    params: dict[str, Any] = {"embed": embed, "ln_f": init_rms(cfg.d_model, device)}
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
    if spec.mixer == "mamba":
        _, nheads, conv_dim = ssm_mod.ssm_dims(
            cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_groups,
            cfg.ssm_state,
        )
        return {
            "mamba": (
                torch.zeros((*lead, batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=dtype, device=device),
                torch.zeros((*lead, batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                            dtype=dtype, device=device),
            )
        }
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


# --------------------------------------------------------------- blocks


def _block(p, spec, cfg, h, cache=None, pos=None, active=None, rope_freqs=None,
           cores="kernel", decode=True):
    """Apply one layer. Decode writes ``cache`` in place; prefill
    (``decode=False``) builds the layer's cache. Returns (h, cache)."""
    x = rms_norm(h, p["ln1"], cfg.rms_eps)
    new_cache: dict[str, Any] = {}
    if spec.mixer == "attn":
        if not decode:
            raise NotImplementedError(
                "attention prefill (attn_prefill) comes with ROADMAP A9"
            )
        a, new_cache["attn"] = ATTENTION[cores](
            p["attn"], x, cache["attn"], pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
            window=spec.window, eps=cfg.rms_eps, active=active,
            rope_freqs=rope_freqs,
        )
    else:
        kwargs = dict(
            expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
            ngroups=cfg.ssm_groups, dstate=cfg.ssm_state, conv=cfg.ssm_conv,
            eps=cfg.rms_eps,
        )
        if decode:
            a, new_cache["mamba"] = ssm_mod.mamba_decode(
                p["mamba"], x, cache["mamba"], active=active, **kwargs)
        else:
            a, new_cache["mamba"] = ssm_mod.mamba_prefill(
                p["mamba"], x, cores=cores, **kwargs)
    h = h + a
    if spec.ffn == "mlp":
        h = h + mlp_apply(p["mlp"], rms_norm(h, p["ln2"], cfg.rms_eps), cfg.act)
    return h, new_cache


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
    cores: str = "kernel",
) -> tuple[torch.Tensor, dict]:
    """ONE new token against the caches. Returns (logits (B, vocab),
    caches) — the caches are the ones passed in, written in place.
    ``cores`` picks the attention core (see ``CORES``)."""
    h = params["embed"][token]
    for i in range(cfg.n_periods):
        for j, spec in enumerate(cfg.period):
            h, _ = _block(_layer(params["period"][j], i), spec, cfg, h,
                          _layer(caches["period"][j], i), pos, active,
                          rope_freqs, cores)
    for j, spec in enumerate(cfg.remainder):
        h, _ = _block(params["remainder"][j], spec, cfg, h,
                      caches["remainder"][j], pos, active, rope_freqs, cores)
    return _logits(params, cfg, h)[:, 0], caches


# --------------------------------------------------------------- prefill


def _logits(params, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params["ln_f"], cfg.rms_eps)
    return h @ params["embed"].T


def _stack(caches: list) -> Any:
    """Per-layer cache structures -> one structure with leaves stacked on
    a leading n_periods axis."""
    first = caches[0]
    if isinstance(first, dict):
        return {k: _stack([c[k] for c in caches]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([c[i] for c in caches]) for i in range(len(first)))
    return torch.stack(caches)


def _run_stack(params, cfg: ArchConfig, h, cores: str):
    """The whole stack over a full sequence (no caches in); returns (h,
    caches) with the caches in the reference's stacked structure."""
    per_layer: list[list] = [[] for _ in cfg.period]
    for i in range(cfg.n_periods):
        for j, spec in enumerate(cfg.period):
            h, c = _block(_layer(params["period"][j], i), spec, cfg, h,
                          cores=cores, decode=False)
            per_layer[j].append(c)
    period = tuple(_stack(cs) for cs in per_layer) if cfg.n_periods else ()
    remainder = []
    for j, spec in enumerate(cfg.remainder):
        h, c = _block(params["remainder"][j], spec, cfg, h, cores=cores, decode=False)
        remainder.append(c)
    return h, {"period": period, "remainder": tuple(remainder)}


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            cores: str = "kernel") -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits (B, S, vocab) and the aux loss (zero: no MoE
    layer is ported)."""
    h, _ = _run_stack(params, cfg, params["embed"][tokens], cores)
    return _logits(params, cfg, h), torch.zeros((), dtype=torch.float32,
                                                device=h.device)


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor, *,
            cores: str = "kernel") -> tuple[torch.Tensor, dict]:
    """Returns (logits for the LAST position (B, vocab), caches).
    ``cores`` picks the SSD core of the Mamba2 layers (see ``CORES``)."""
    h, caches = _run_stack(params, cfg, params["embed"][tokens], cores)
    return _logits(params, cfg, h[:, -1:])[:, 0], caches


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
