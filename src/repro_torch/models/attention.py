"""GQA attention: chunked-causal prefill and single-token cached decode.

Port of the reference's ``models/attention.py``:

* ``_project_qkv`` — q/k/v projections, qk-norm BEFORE RoPE (Qwen3,
  gemma3);
* ``attn_prefill`` — causal (optionally windowed) attention over a whole
  sequence with the reference's query chunking (``attention.py:78-189``);
  its ``lax.map`` over the chunks is a Python loop here. A sliding-window
  layer returns a RING-BUFFER cache of ``window`` positions, rolled so
  that slot = position % window;
* ``attn_decode`` — the plain attention, kept for parity tests and taken
  by window layers (``attention.py:192-242``). A window layer writes its
  ring at ``pos % T`` and masks each slot by the position it holds;
* ``attn_decode_kernel`` — the counterpart of the reference's
  ``attn_decode_kernel`` (``attention.py:245-289``): the same K/V write,
  then the ``repro_torch::flash_decode`` op as the attention core. This
  is the attention of the served decode step on global layers; window
  layers take ``attn_decode``, as in the reference.

Cast points are the reference's: scores come out of the einsum in the
working dtype and are scaled in fp32 (the reference's scale is a numpy
float64 scalar, which promotes a bf16 array to fp32), the softmax runs
in fp32, and the probabilities are cast back to the working dtype
before the PV product.

Caches are updated IN PLACE by decode (the reference returns new
arrays): the cache tensors are zero-copy views into the engine's one
state buffer, so writing the new K/V row there is what keeps the state
in that buffer. The write keeps the reference's meaning — slot
``min(pos, T-1)`` (``pos % T`` on a ring), inactive rows untouched — but
not its out-of-bounds trick (an OOB ``index_put_`` is a device-side
assert on CUDA): every row writes ``where(active, new, old)`` at its
slot. Nothing here reads a value back to the host, and no shape depends
on ``pos``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.layers import init_linear, init_rms, rms_norm, rope

NEG_INF = -1e30


def attn_init(generator, lead: tuple[int, ...], d_model: int, n_heads: int,
              n_kv: int, head_dim: int, qk_norm: bool, dtype, device) -> dict:
    p = {
        "wq": init_linear(generator, (*lead, d_model, n_heads * head_dim), dtype, device),
        "wk": init_linear(generator, (*lead, d_model, n_kv * head_dim), dtype, device),
        "wv": init_linear(generator, (*lead, d_model, n_kv * head_dim), dtype, device),
        "wo": init_linear(generator, (*lead, n_heads * head_dim, d_model), dtype, device),
    }
    if qk_norm:
        p["q_norm"] = init_rms(head_dim, device, lead)
        p["k_norm"] = init_rms(head_dim, device, lead)
    return p


def _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta, eps, rope_freqs):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(B, S, n_kv, head_dim)
    v = (x @ p["wv"]).reshape(B, S, n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    q = rope(q, positions, theta, rope_freqs)
    k = rope(k, positions, theta, rope_freqs)
    return q, k, v


def _write_kv(k_cache, v_cache, k, v, slot_b, active):
    """Write this token's K/V row in place at each row's ``slot_b``;
    rows with ``active == False`` write back what is there."""
    B = k_cache.shape[0]
    rows = torch.arange(B, device=k_cache.device)
    k_new, v_new = k[:, 0].to(k_cache.dtype), v[:, 0].to(v_cache.dtype)
    if active is not None:
        keep = active[:, None, None]
        k_new = torch.where(keep, k_new, k_cache[rows, slot_b])
        v_new = torch.where(keep, v_new, v_cache[rows, slot_b])
    k_cache[rows, slot_b] = k_new
    v_cache[rows, slot_b] = v_new


def _gqa_scores(q, k):
    """q (B,S,H,D), k (B,T,KV,D) -> scores (B,H,S,T) with GQA broadcast."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", q.reshape(B, S, KV, H // KV, D), k)
    return s.reshape(B, H, S, k.shape[1])


def _gqa_out(probs, v):
    """probs (B,H,S,T), v (B,T,KV,D) -> (B,S,H*D)."""
    B, H, S, T = probs.shape
    KV = v.shape[2]
    o = torch.einsum("bkgst,btkd->bskgd", probs.reshape(B, KV, H // KV, S, T), v)
    # through (B·S, H·D): at S = 1 the einsum's result has a size-1 axis
    # whose stride fake tensors set otherwise than the CPU does, and a
    # traced matmul by wo would then take bmm where eager takes mm
    return o.reshape(B * S, H * v.shape[-1]).view(B, S, H * v.shape[-1])


def attn_prefill(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    theta: float,
    window: int | None,
    eps: float = 1e-6,
    q_chunk: int = 512,
    positions: torch.Tensor | None = None,
    rope_freqs: torch.Tensor | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Causal (optionally windowed) attention over the full sequence.
    Returns (out (B,S,D), (k_cache, v_cache)): the whole K/V for a global
    layer, the ring of the last ``window`` positions for a window layer.

    The query chunking is the reference's, so a traced prefill holds
    tensors of the reference's sizes: for S <= 8192 without a window,
    ``q_chunk = max(q_chunk, ceil(S/16))`` and chunk i attends keys
    ``[0, (i+1)·C)``; with a window, each chunk attends a key slice of
    ``Lk = min(S, (ceil((W-1)/C)+1)·C)`` positions; longer causal
    sequences mask a full (C, S) tile per chunk; S <= C is one chunk."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta,
                           eps, rope_freqs)
    scale = 1.0 / np.sqrt(head_dim)
    causal_unroll = window is None and S <= 8192
    if causal_unroll:
        q_chunk = max(q_chunk, -(-S // 16))  # bound the unroll at 16 bodies
    C = min(q_chunk, S)
    n_chunks = -(-S // C)
    pad = n_chunks * C - S
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))

    def arange(start, n):
        return torch.arange(start, start + n, device=x.device)[None, :]

    def attend(qi, ki, vi, qpos, kpos):
        """qi (B,C,H,D) vs ki/vi (B,Lk,KV,D) with position masks."""
        s = _gqa_scores(qi, ki).float() * scale  # (B,H,C,Lk)
        mask = kpos[:, None, :] <= qpos[..., None]  # (1,C,Lk)
        if window is not None:
            mask = mask & (kpos[:, None, :] > qpos[..., None] - window)
        s = torch.where(mask[:, None, :, :], s, NEG_INF)
        probs = torch.softmax(s, dim=-1).to(x.dtype)
        return _gqa_out(probs, vi)  # (B,C,H*D)

    outs = []
    if window is not None and S > C:
        # each query chunk reads only the Lk keys that can be in its window
        Lk = min(S, (-(-(window - 1) // C) + 1) * C)
        for i in range(n_chunks):
            start = i * C
            k0 = min(max(start + C - Lk, 0), S - Lk)
            outs.append(attend(q[:, start:start + C], k[:, k0:k0 + Lk],
                               v[:, k0:k0 + Lk], arange(start, C), arange(k0, Lk)))
    elif causal_unroll and S > C:
        # chunk i attends keys [0, (i+1)·C): static key lengths per chunk
        for i in range(n_chunks):
            hi = min((i + 1) * C, S)
            outs.append(attend(q[:, i * C:(i + 1) * C], k[:, :hi], v[:, :hi],
                               arange(i * C, C), arange(0, hi)))
    elif S > C:
        # long-S causal: every chunk masks the whole (C, S) tile
        for i in range(n_chunks):
            outs.append(attend(q[:, i * C:(i + 1) * C], k, v, arange(i * C, C),
                               arange(0, S)))
    else:
        outs.append(attend(q, k, v, arange(0, S), arange(0, S)))
    out = torch.stack(outs, dim=1).reshape(B, n_chunks * C, n_heads * head_dim)
    out = out[:, :S] @ p["wo"]
    if window is None:
        return out, (k, v)
    # the ring: the last `window` keys/values (zero-padded when S < W),
    # rolled so that cache slot = position % W
    W = window
    if S >= W:
        k_c, v_c = k[:, S - W:], v[:, S - W:]
        shift = (S - W) % W
    else:
        k_c = F.pad(k, (0, 0, 0, 0, 0, W - S))
        v_c = F.pad(v, (0, 0, 0, 0, 0, W - S))
        shift = 0
    return out, (torch.roll(k_c, shift, dims=1), torch.roll(v_c, shift, dims=1))


def _positions(pos, B, device):
    return torch.as_tensor(pos, dtype=torch.int32, device=device).expand(B)


def attn_decode(
    p: dict,
    x: torch.Tensor,  # (B, 1, D)
    cache: tuple[torch.Tensor, torch.Tensor],  # (B, T, KV, hd) x2, updated in place
    pos,  # int or (B,) int32 — per-slot positions (0-based)
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    theta: float,
    window: int | None,
    eps: float = 1e-6,
    active: torch.Tensor | None = None,  # (B,) bool — continuous batching mask
    rope_freqs: torch.Tensor | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode with the plain attention; returns (out (B,1,D),
    cache). A window layer's cache is a ring of T slots: it writes slot
    ``pos % T``, and slot i, which holds the largest position p <= pos
    with p % T == i, is read when ``pos - window < p``."""
    B = x.shape[0]
    k_cache, v_cache = cache
    T = k_cache.shape[1]
    pos_b = _positions(pos, B, x.device)
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, pos_b[:, None],
                           theta, eps, rope_freqs)
    slot_b = pos_b % T if window is not None else torch.clamp(pos_b, max=T - 1)
    _write_kv(k_cache, v_cache, k, v, slot_b, active)
    scale = 1.0 / np.sqrt(head_dim)
    s = _gqa_scores(q, k_cache).float() * scale  # (B,H,1,T)
    idx = torch.arange(T, device=x.device)[None, None, None, :]
    pb = pos_b[:, None, None, None]
    if window is None:
        mask = idx <= pb
    else:
        # a floor modulo (the tensor %): pb - idx < 0 on half the ring
        slot_pos = pb - ((pb - idx) % T)
        mask = (slot_pos >= 0) & (slot_pos <= pb) & (slot_pos > pb - window)
    s = torch.where(mask, s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(x.dtype)
    out = _gqa_out(probs, v_cache)  # (B,1,H*D)
    return out @ p["wo"], (k_cache, v_cache)


def attn_decode_kernel(
    p: dict,
    x: torch.Tensor,  # (B, 1, D)
    cache: tuple[torch.Tensor, torch.Tensor],
    pos,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    theta: float,
    window: int | None,
    eps: float = 1e-6,
    active: torch.Tensor | None = None,
    rope_freqs: torch.Tensor | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """``attn_decode`` with ``repro_torch::flash_decode`` as the attention
    core: the K/V write, then single-pass attention over the cache at
    ``lengths = min(pos+1, T)``. Window layers take the plain decode,
    as in the reference: the kernel reads positions [0, length), not a
    ring."""
    if window is not None:
        return attn_decode(
            p, x, cache, pos, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim,
            theta=theta, window=window, eps=eps, active=active,
            rope_freqs=rope_freqs,
        )
    B = x.shape[0]
    k_cache, v_cache = cache
    T = k_cache.shape[1]
    pos_b = _positions(pos, B, x.device)
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, pos_b[:, None],
                           theta, eps, rope_freqs)
    _write_kv(k_cache, v_cache, k, v, torch.clamp(pos_b, max=T - 1), active)
    G = n_heads // n_kv
    q_k = q.reshape(B, n_kv, G, head_dim)
    lengths = torch.clamp(pos_b + 1, max=T).to(torch.int32)
    o = flash_decode(q_k, k_cache, v_cache, lengths)
    out = o.reshape(B, 1, n_heads * head_dim)
    return out @ p["wo"], (k_cache, v_cache)
