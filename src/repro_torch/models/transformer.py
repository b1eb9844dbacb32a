"""Config-driven decoder stack: params, caches, prefill, forward and the
decode step.

Port of the reference's ``models/transformer.py`` for the layer specs
of the decoder families: attention (global or sliding-window) + MLP,
attention + MoE (``models/moe.py``: the reference's grouped capacity
dispatch, its Switch aux loss summed over the layers by ``forward``,
discarded by ``prefill`` and the decode step as in the reference), and
Mamba2 with no FFN, each with prefill, forward and decode; a layer may
first apply zamba2's shared attention block (``_apply_shared_attn``:
one set of params at 2·d_model, read at every insertion, with its own
RoPE table at its own head dim). ``forward`` and ``prefill`` put a VLM's
``prefix_embeds`` in front of the token embeddings. The enc-dec family
is ``models/encdec.py``.

The layer program is ``period × n_periods + remainder``. Period params
and caches are stacked on a leading ``n_periods`` axis, as in the
reference; the reference scans that axis with ``lax.scan``, the port
runs a Python loop over it and reads layer i as a view of the stack.

Caches mirror the reference's structure —
``{"period": ({"attn": (k, v)} or {"mamba": (conv, ssm)}, ...),
"remainder": (...)}`` with period leaves ``(n_periods, B, T, KV, hd)``,
``(n_periods, B, conv-1, conv_dim)`` and ``(n_periods, B, H, P, N)``;
a sliding-window layer's T is ``min(window, cache_len)`` (a ring); a
layer with the shared block adds ``"shared": (k, v)`` of
``(n_periods, B, T, shared_heads, 2·d_model / shared_heads)``. Each
layer's dict is built with its keys sorted, the order in which JAX
flattens the reference's, so both packages list the leaves alike — and
are updated IN PLACE by the decode step (see ``models/attention.py``
and ``models/ssm.py``). ``prefill`` returns new caches, stacked the same
way, at the prompt's length (a window layer's at ``window``);
``grow_caches`` pads the global ones to a decode capacity.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (init_linear, init_rms, mlp_apply, mlp_init,
                                      remat_call, rms_norm)

# the cores of the layers: "kernel" (the served path, the repro_torch ops
# flash_decode and ssd_chunk) or "plain" (their plain versions, for parity
# checks on the card)
CORES = ("kernel", "plain")
ATTENTION = {"kernel": attn.attn_decode_kernel, "plain": attn.attn_decode}


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# the layer specs the port builds: (mixer, ffn)
PORTED_SPECS = (("attn", "mlp"), ("attn", "moe"), ("mamba", "none"))


def _check_spec(spec: LayerSpec) -> None:
    if (spec.mixer, spec.ffn) not in PORTED_SPECS:
        raise NotImplementedError(
            f"layer {spec}: the port builds attention + MLP, attention + MoE "
            f"and Mamba2 layers, each with or without the shared block"
        )


def has_shared_attn(cfg: ArchConfig) -> bool:
    return any(s.shared_attn for s in (*cfg.period, *cfg.remainder))


def shared_head_dim(cfg: ArchConfig) -> int:
    """The shared block's head dim: 2·d_model over its heads."""
    return 2 * cfg.d_model // cfg.shared_attn_heads


def _sorted(d: dict) -> dict:
    return {k: d[k] for k in sorted(d)}


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
    elif spec.ffn == "moe":
        p["moe"] = moe_mod.moe_init(generator, lead, cfg.d_model, cfg.d_ff,
                                    cfg.n_experts, cfg.act, cfg.shared_expert,
                                    dtype, device)
    return p


def _shared_attn_init(generator, cfg: ArchConfig, device) -> dict:
    """zamba2's shared block (reference ``transformer.py:69-84``):
    concat(h, emb0) -> attention + MLP at 2·d_model, no qk-norm,
    projected back to d_model. One set, no lead axis."""
    dtype = _dtype(cfg)
    d2 = 2 * cfg.d_model
    H = cfg.shared_attn_heads
    return {
        "ln": init_rms(d2, device),
        "attn": attn.attn_init(generator, (), d2, H, H, shared_head_dim(cfg),
                               False, dtype, device),
        "mlp": mlp_init(generator, (), d2, cfg.d_ff, cfg.act, dtype, device),
        "ln2": init_rms(d2, device),
        "out": init_linear(generator, (d2, cfg.d_model), dtype, device),
    }


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
    if has_shared_attn(cfg):
        params["shared_attn"] = _shared_attn_init(generator, cfg, device)
    return params


def _empty_cache_for_spec(spec, cfg, lead, batch, cache_len, dtype, device) -> dict:
    _check_spec(spec)

    def zeros(*shape):
        return torch.zeros((*lead, batch, *shape), dtype=dtype, device=device)

    c: dict[str, Any] = {}
    if spec.shared_attn:
        shape = (cache_len, cfg.shared_attn_heads, shared_head_dim(cfg))
        c["shared"] = (zeros(*shape), zeros(*shape))
    if spec.mixer == "mamba":
        _, nheads, conv_dim = ssm_mod.ssm_dims(
            cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_groups,
            cfg.ssm_state,
        )
        c["mamba"] = (zeros(cfg.ssm_conv - 1, conv_dim),
                      zeros(nheads, cfg.ssm_head_dim, cfg.ssm_state))
    else:
        T = min(spec.window, cache_len) if spec.window else cache_len
        shape = (T, cfg.n_kv_heads, cfg.resolved_head_dim)
        c["attn"] = (zeros(*shape), zeros(*shape))
    return _sorted(c)


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


def _apply_shared_attn(sp, h, emb0, cfg, cache=None, pos=None, active=None,
                       freqs=None, cores="kernel", constrain=None):
    """zamba2's shared block (reference ``transformer.py:120-140``):
    attention + MLP over concat(h, emb0) at 2·d_model, its own heads and
    RoPE table ``freqs`` (at ``shared_head_dim``), global. Prefill when
    ``cache`` is None, else one decode step on ``cache`` (in place, with
    the attention core of ``cores``). Returns (delta (…, d_model), kv)."""
    x = rms_norm(torch.cat([h, emb0], dim=-1), sp["ln"], cfg.rms_eps)
    H = cfg.shared_attn_heads
    kwargs = dict(n_heads=H, n_kv=H, head_dim=shared_head_dim(cfg),
                  theta=cfg.rope_theta, window=None, eps=cfg.rms_eps,
                  rope_freqs=freqs, constrain=constrain)
    if cache is None:
        a, kv = attn.attn_prefill(sp["attn"], x, **kwargs)
    else:
        a, kv = ATTENTION[cores](sp["attn"], x, cache, pos, active=active, **kwargs)
    y = x + a
    y = y + mlp_apply(sp["mlp"], rms_norm(y, sp["ln2"], cfg.rms_eps), cfg.act,
                      constrain)
    return y @ sp["out"], kv


def _block(p, spec, cfg, h, cache=None, pos=None, active=None, rope_freqs=None,
           cores="kernel", decode=True, shared=None, constrain=None):
    """Apply one layer. Decode writes ``cache`` in place; prefill
    (``decode=False``) builds the layer's cache. ``shared`` is
    ``(params, emb0, freqs)`` of the shared block, which a layer with
    ``spec.shared_attn`` applies first. Returns (h, cache, aux): ``aux``
    is the MoE layer's Switch aux loss, None for other layers."""
    new_cache: dict[str, Any] = {}
    if spec.shared_attn:
        sp, emb0, freqs = shared
        delta, new_cache["shared"] = _apply_shared_attn(
            sp, h, emb0, cfg, cache["shared"] if decode else None, pos, active,
            freqs, cores, constrain)
        h = h + delta
    x = rms_norm(h, p["ln1"], cfg.rms_eps)
    if spec.mixer == "attn":
        kwargs = dict(
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, theta=cfg.rope_theta,
            window=spec.window, eps=cfg.rms_eps, rope_freqs=rope_freqs,
            constrain=constrain,
        )
        if decode:
            a, new_cache["attn"] = ATTENTION[cores](
                p["attn"], x, cache["attn"], pos, active=active, **kwargs)
        else:
            a, new_cache["attn"] = attn.attn_prefill(p["attn"], x, **kwargs)
    else:
        kwargs = dict(
            expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim,
            ngroups=cfg.ssm_groups, dstate=cfg.ssm_state, conv=cfg.ssm_conv,
            eps=cfg.rms_eps, constrain=constrain,
        )
        if decode:
            a, new_cache["mamba"] = ssm_mod.mamba_decode(
                p["mamba"], x, cache["mamba"], active=active, **kwargs)
        else:
            a, new_cache["mamba"] = ssm_mod.mamba_prefill(
                p["mamba"], x, cores=cores, **kwargs)
    h = h + a
    aux = None
    if spec.ffn == "mlp":
        h = h + mlp_apply(p["mlp"], rms_norm(h, p["ln2"], cfg.rms_eps), cfg.act,
                          constrain)
    elif spec.ffn == "moe":
        delta, aux = moe_mod.moe_apply(
            p["moe"], rms_norm(h, p["ln2"], cfg.rms_eps), n_experts=cfg.n_experts,
            top_k=cfg.top_k, act=cfg.act, capacity_factor=cfg.capacity_factor,
            constrain=constrain)
        h = h + delta
    if constrain is not None:
        h = constrain(h, "hidden")
    return h, _sorted(new_cache), aux


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
    shared_freqs: torch.Tensor | None = None,
    cores: str = "kernel",
    constrain=None,
) -> tuple[torch.Tensor, dict]:
    """ONE new token against the caches. Returns (logits (B, vocab),
    caches) — the caches are the ones passed in, written in place.
    ``cores`` picks the attention core (see ``CORES``); the shared block's
    ``emb0`` is the current token's embedding, as in the reference.
    ``constrain(x, tag)``, if given, is called at the reference's sites
    (``launch/mesh.ShardingCtx.constrain`` in a sharded step)."""
    h = params["embed"][token]
    shared = (params.get("shared_attn"), h, shared_freqs)
    if constrain is not None:
        h = constrain(h, "hidden")
    for i in range(cfg.n_periods):
        for j, spec in enumerate(cfg.period):
            h, _, _ = _block(_layer(params["period"][j], i), spec, cfg, h,
                             _layer(caches["period"][j], i), pos, active,
                             rope_freqs, cores, shared=shared, constrain=constrain)
    for j, spec in enumerate(cfg.remainder):
        h, _, _ = _block(params["remainder"][j], spec, cfg, h,
                         caches["remainder"][j], pos, active, rope_freqs, cores,
                         shared=shared, constrain=constrain)
    return _logits(params, cfg, h, constrain)[:, 0], caches


# --------------------------------------------------------------- prefill


def _logits(params, cfg: ArchConfig, h: torch.Tensor, constrain=None
            ) -> torch.Tensor:
    h = rms_norm(h, params["ln_f"], cfg.rms_eps)
    logits = h @ params["embed"].T
    if constrain is not None:
        logits = constrain(logits, "logits")
    return logits


def _stack(caches: list) -> Any:
    """Per-layer cache structures -> one structure with leaves stacked on
    a leading n_periods axis."""
    first = caches[0]
    if isinstance(first, dict):
        return {k: _stack([c[k] for c in caches]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([c[i] for c in caches]) for i in range(len(first)))
    return torch.stack(caches)


def _add_aux(total, aux):
    if aux is None:
        return total
    return aux if total is None else total + aux


def _period(params, cfg: ArchConfig, i: int, h, rope_freqs, cores: str, shared,
            constrain=None):
    """Period ``i`` of the stack over a full sequence: (h, the layers'
    caches, their aux losses summed or None)."""
    caches, total = [], None
    for j, spec in enumerate(cfg.period):
        h, c, aux = _block(_layer(params["period"][j], i), spec, cfg, h,
                           rope_freqs=rope_freqs, cores=cores, decode=False,
                           shared=shared, constrain=constrain)
        caches.append(c)
        total = _add_aux(total, aux)
    return h, caches, total


def _run_stack(params, cfg: ArchConfig, h, cores: str, rope_freqs=None,
               shared_freqs=None, remat: bool = False, constrain=None):
    """The whole stack over a full sequence (no caches in); returns (h,
    caches, aux) with the caches in the reference's stacked structure
    and aux the MoE layers' aux losses summed in layer order (None
    without a MoE layer). The shared block's ``emb0`` is ``h`` as it
    enters the stack. ``remat`` recomputes each period in the backward
    pass (``layers.remat_call``, the counterpart of the reference's
    ``jax.checkpoint(period_body)``); the remainder is not wrapped, as in
    the reference."""
    shared = (params.get("shared_attn"), h, shared_freqs)
    per_layer: list[list] = [[] for _ in cfg.period]
    total = None
    for i in range(cfg.n_periods):
        if remat:
            h, cs, aux = remat_call(_period, params, cfg, i, h, rope_freqs, cores,
                                    shared, constrain)
        else:
            h, cs, aux = _period(params, cfg, i, h, rope_freqs, cores, shared,
                                 constrain)
        for j, c in enumerate(cs):
            per_layer[j].append(c)
        total = _add_aux(total, aux)
    period = tuple(_stack(cs) for cs in per_layer) if cfg.n_periods else ()
    remainder = []
    for j, spec in enumerate(cfg.remainder):
        h, c, aux = _block(params["remainder"][j], spec, cfg, h,
                           rope_freqs=rope_freqs, cores=cores, decode=False,
                           shared=shared, constrain=constrain)
        remainder.append(c)
        total = _add_aux(total, aux)
    return h, {"period": period, "remainder": tuple(remainder)}, total


def _embed(params, tokens, prefix_embeds):
    """Token embeddings, with a VLM's ``prefix_embeds`` (B, P, D) in
    front, cast to their dtype (reference ``transformer.py:393-398``)."""
    h = params["embed"][tokens]
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    return h


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None, *, cores: str = "kernel",
            rope_freqs: torch.Tensor | None = None,
            shared_freqs: torch.Tensor | None = None, remat: bool = False,
            constrain=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits (B, P + S, vocab) and the aux loss: the MoE
    layers' Switch losses summed, a fp32 zero without a MoE layer.
    ``remat`` recomputes each period in the backward pass."""
    h = _embed(params, tokens, prefix_embeds)
    if constrain is not None:
        h = constrain(h, "hidden")
    h, _, aux = _run_stack(params, cfg, h, cores, rope_freqs, shared_freqs, remat,
                           constrain)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _logits(params, cfg, h, constrain), aux


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            prefix_embeds: torch.Tensor | None = None, *, cores: str = "kernel",
            rope_freqs: torch.Tensor | None = None,
            shared_freqs: torch.Tensor | None = None, constrain=None
            ) -> tuple[torch.Tensor, dict]:
    """Returns (logits for the LAST position (B, vocab), caches) over
    ``prefix_embeds`` (if any) and ``tokens``. ``cores`` picks the SSD
    core of the Mamba2 layers (see ``CORES``); attention prefill has one
    core, the plain chunked attention, as in the reference."""
    h, caches, _ = _run_stack(params, cfg, _embed(params, tokens, prefix_embeds),
                              cores, rope_freqs, shared_freqs, constrain=constrain)
    return _logits(params, cfg, h[:, -1:], constrain)[:, 0], caches


def grow_caches(cfg: ArchConfig, caches: dict, new_len: int) -> dict:
    """Pad attention caches (axis -3 of (…, B, T, KV, hd)) with zeros to
    ``new_len`` so decode can continue past the prefill length
    (reference ``transformer.py:336``). Ring-buffer (window) caches grow
    to at most ``window``, the shared block's as a global one, and Mamba2
    states keep their size. Returns new
    caches; a leaf that needs no padding is returned as it is."""

    def pad_kv(kv, keep: int | None):
        k, v = kv
        T = k.shape[-3]
        target = min(keep, new_len) if keep else new_len
        if T >= target:
            return (k, v)
        pad = (0, 0, 0, 0, 0, target - T)
        return (torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad))

    def grow_spec(spec: LayerSpec, c: dict) -> dict:
        out = dict(c)
        if "attn" in c:
            out["attn"] = pad_kv(c["attn"], spec.window)
        if "shared" in c:
            out["shared"] = pad_kv(c["shared"], None)
        return out

    return {
        "period": tuple(grow_spec(spec, c)
                        for spec, c in zip(cfg.period, caches["period"])),
        "remainder": tuple(grow_spec(spec, c)
                           for spec, c in zip(cfg.remainder, caches["remainder"])),
    }


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
