"""Encoder–decoder backbone (seamless-m4t style, arXiv:2308.11596).

Port of the reference's ``models/encdec.py``. The audio frontend (mel
spectrogram + conv feature extractor) is a stub there and here: the
caller supplies frame embeddings (B, S_enc, d_model). The transformer
itself is ported: a bidirectional encoder (``_bidir_attn``, RoPE'd full
attention) and a causal decoder with cross-attention over the encoder
output, whose K/V every decoder layer projects once (``cross_kv``).

Params are stacked on a leading layer axis (``enc``: encoder_layers,
``dec``: n_layers), as the reference's ``vmap``-ed init lays them out;
the reference scans that axis, the port loops over it. The decode caches
are ``{"self": (k, v), "cross": (k, v)}`` with leaves (L, B, T, KV, hd);
the decode step writes the self-attention K/V IN PLACE, as the decoder
families' step does (``models/attention.py``), and returns the caches it
was given.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import init_rms, mlp_apply, mlp_init, remat_call, rms_norm
from repro_torch.models.transformer import ATTENTION, _dtype, _layer


def _enc_layer_init(generator, lead, cfg: ArchConfig, dtype, device) -> dict:
    return {
        "ln1": init_rms(cfg.d_model, device, lead),
        "attn": attn.attn_init(
            generator, lead, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.qk_norm, dtype, device,
        ),
        "ln2": init_rms(cfg.d_model, device, lead),
        "mlp": mlp_init(generator, lead, cfg.d_model, cfg.d_ff, cfg.act, dtype,
                        device),
    }


def _dec_layer_init(generator, lead, cfg: ArchConfig, dtype, device) -> dict:
    p = _enc_layer_init(generator, lead, cfg, dtype, device)
    p["ln_x"] = init_rms(cfg.d_model, device, lead)
    p["xattn"] = attn.cross_attn_init(
        generator, lead, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
        cfg.resolved_head_dim, dtype, device,
    )
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator, device) -> dict:
    """Random params with the reference's distributions (embed
    N(0,1)/√d_model, linears U(±1/√d_in), rms scales zero); the numbers
    differ from ``jax.random``'s (``bridge.params_from_numpy`` brings the
    reference's own over). On ``"meta"`` nothing is drawn."""
    dtype = _dtype(cfg)
    if torch.device(device).type == "meta":
        embed = torch.empty((cfg.vocab, cfg.d_model), dtype=dtype, device=device)
    else:
        emb = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                          dtype=torch.float32, device=generator.device)
        embed = (emb * (1.0 / np.sqrt(cfg.d_model))).to(device=device, dtype=dtype)
        del emb
    return {
        "embed": embed,
        "enc": _enc_layer_init(generator, (cfg.encoder_layers,), cfg, dtype, device),
        "dec": _dec_layer_init(generator, (cfg.n_layers,), cfg, dtype, device),
        "ln_f": init_rms(cfg.d_model, device),
        "ln_enc": init_rms(cfg.d_model, device),
    }


def _bidir_attn(p, x, cfg: ArchConfig, rope_freqs=None, constrain=None):
    """Full bidirectional self-attention for the encoder."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = attn._project_qkv(p, x, cfg.n_heads, cfg.n_kv_heads, hd, positions,
                                cfg.rope_theta, cfg.rms_eps, rope_freqs)
    if constrain is not None:
        q = constrain(q, "heads")
    s = attn._gqa_scores(q, k).float() / np.sqrt(hd)
    probs = torch.softmax(s, dim=-1).to(x.dtype)
    return attn._gqa_out(probs, v) @ p["wo"]


def encode(params, cfg: ArchConfig, frames: torch.Tensor, rope_freqs=None,
           constrain=None) -> torch.Tensor:
    """frames (B, S_enc, D) stub embeddings -> encoder output (B, S_enc, D)."""
    h = frames.to(_dtype(cfg))
    if constrain is not None:
        h = constrain(h, "hidden")
    for i in range(cfg.encoder_layers):
        lp = _layer(params["enc"], i)
        x = rms_norm(h, lp["ln1"], cfg.rms_eps)
        h = h + _bidir_attn(lp["attn"], x, cfg, rope_freqs, constrain)
        h = h + mlp_apply(lp["mlp"], rms_norm(h, lp["ln2"], cfg.rms_eps), cfg.act,
                          constrain)
        if constrain is not None:
            h = constrain(h, "hidden")
    return rms_norm(h, params["ln_enc"], cfg.rms_eps)


def cross_kv(params, cfg: ArchConfig, enc_out: torch.Tensor):
    """Every decoder layer's cross-attention K/V, stacked over the layers
    ((L, B, S_enc, KV, hd) each)."""
    hd = cfg.resolved_head_dim
    kvs = [attn.encode_kv(_layer(params["dec"]["xattn"], i), enc_out,
                          cfg.n_kv_heads, hd) for i in range(cfg.n_layers)]
    return (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))


def _dec_block(lp, cfg: ArchConfig, h, enc_kv, cache=None, pos=None, active=None,
               rope_freqs=None, cores: str = "kernel", constrain=None):
    """One decoder layer: causal self-attention (prefill when ``cache`` is
    None, else one decode step on ``cache``, in place), cross-attention
    over ``enc_kv``, MLP. Returns (h, self-attention K/V)."""
    hd = cfg.resolved_head_dim
    x = rms_norm(h, lp["ln1"], cfg.rms_eps)
    kwargs = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=hd,
                  theta=cfg.rope_theta, window=None, eps=cfg.rms_eps,
                  rope_freqs=rope_freqs, constrain=constrain)
    if cache is None:
        a, kv = attn.attn_prefill(lp["attn"], x, **kwargs)
    else:
        a, kv = ATTENTION[cores](lp["attn"], x, cache, pos, active=active, **kwargs)
    h = h + a
    h = h + attn.cross_attn(lp["xattn"], rms_norm(h, lp["ln_x"], cfg.rms_eps),
                            enc_kv, n_heads=cfg.n_heads, head_dim=hd,
                            constrain=constrain)
    h = h + mlp_apply(lp["mlp"], rms_norm(h, lp["ln2"], cfg.rms_eps), cfg.act,
                      constrain)
    if constrain is not None:
        h = constrain(h, "hidden")
    return h, kv


def _logits(params, cfg: ArchConfig, h: torch.Tensor, constrain=None
            ) -> torch.Tensor:
    logits = rms_norm(h, params["ln_f"], cfg.rms_eps) @ params["embed"].T
    if constrain is not None:
        logits = constrain(logits, "logits")
    return logits


def forward(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            frames: torch.Tensor, *, remat: bool = False, rope_freqs=None,
            constrain=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced training forward -> (logits (B, S, vocab), aux = 0).
    ``remat`` recomputes each decoder layer in the backward pass
    (``layers.remat_call``, the counterpart of the reference's
    ``jax.checkpoint`` of its scan body)."""
    enc_out = encode(params, cfg, frames, rope_freqs, constrain)
    ks, vs = cross_kv(params, cfg, enc_out)
    h = params["embed"][tokens]

    def body(lp, h, k, v):
        return _dec_block(lp, cfg, h, (k, v), rope_freqs=rope_freqs,
                          constrain=constrain)[0]

    for i in range(cfg.n_layers):
        lp = _layer(params["dec"], i)
        if remat:
            h = remat_call(body, lp, h, ks[i], vs[i])
        else:
            h = body(lp, h, ks[i], vs[i])
    return _logits(params, cfg, h, constrain), torch.zeros(
        (), dtype=torch.float32, device=h.device)


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, enc_len: int,
               device) -> dict:
    dtype = _dtype(cfg)
    hd = cfg.resolved_head_dim
    L = cfg.n_layers

    def zeros(T):
        return torch.zeros((L, batch, T, cfg.n_kv_heads, hd), dtype=dtype,
                           device=device)

    return {"self": (zeros(cache_len), zeros(cache_len)),
            "cross": (zeros(enc_len), zeros(enc_len))}


def prefill(params, cfg: ArchConfig, tokens, frames, *, rope_freqs=None,
            constrain=None) -> tuple[torch.Tensor, dict]:
    """Encode + a teacher-forced pass over the prompt; returns (last
    logits (B, vocab), caches with 'self' at the prompt's length and
    'cross')."""
    enc_out = encode(params, cfg, frames, rope_freqs, constrain)
    ks, vs = cross_kv(params, cfg, enc_out)
    h = params["embed"][tokens]
    self_k, self_v = [], []
    for i in range(cfg.n_layers):
        h, (k, v) = _dec_block(_layer(params["dec"], i), cfg, h, (ks[i], vs[i]),
                               rope_freqs=rope_freqs, constrain=constrain)
        self_k.append(k)
        self_v.append(v)
    logits = _logits(params, cfg, h[:, -1:])[:, 0]
    return logits, {"self": (torch.stack(self_k), torch.stack(self_v)),
                    "cross": (ks, vs)}


def decode_step(params: dict, cfg: ArchConfig, token: torch.Tensor, caches: dict,
                pos, active: torch.Tensor | None = None, *, rope_freqs=None,
                cores: str = "kernel", constrain=None) -> tuple[torch.Tensor, dict]:
    """ONE new token; the self-attention caches are written in place."""
    h = params["embed"][token]
    if constrain is not None:
        h = constrain(h, "hidden")
    (sk, sv), (ck, cv) = caches["self"], caches["cross"]
    for i in range(cfg.n_layers):
        h, _ = _dec_block(_layer(params["dec"], i), cfg, h, (ck[i], cv[i]),
                          (sk[i], sv[i]), pos, active, rope_freqs, cores, constrain)
    return _logits(params, cfg, h, constrain)[:, 0], caches


def reset_slots(caches: dict, keep: torch.Tensor) -> dict:
    """Zero the slots where ``keep`` is False, in place: every leaf is
    (L, B, ...), batch on axis 1."""
    for leaf in (*caches["self"], *caches["cross"]):
        shape = [1] * leaf.dim()
        shape[1] = leaf.shape[1]
        leaf.mul_(keep.to(leaf.dtype).reshape(shape))
    return caches
