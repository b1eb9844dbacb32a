"""GQA single-token cached decode attention.

Port of the decode half of the reference's ``models/attention.py``:

* ``_project_qkv`` — q/k/v projections, qk-norm BEFORE RoPE (Qwen3);
* ``attn_decode`` — the plain attention, kept for parity tests: scores
  in the working dtype, softmax in fp32 cast back to x.dtype before the
  PV product (reference ``attention.py:192-242``);
* ``attn_decode_kernel`` — the counterpart of the reference's
  ``attn_decode_kernel`` (``attention.py:245-289``): the same K/V write,
  then the ``repro_torch::flash_decode`` op as the attention core. This
  is the attention of the served decode step.

Caches are updated IN PLACE (the reference returns new arrays): the
cache tensors are zero-copy views into the engine's one state buffer, so
writing the new K/V row there is what keeps the state in that buffer.
The write keeps the reference's meaning — slot ``min(pos, T-1)``,
inactive rows untouched — but not its out-of-bounds trick (an OOB
``index_put_`` is a device-side assert on CUDA): every row writes
``where(active, new, old)`` at its clamped slot. Nothing here reads a
value back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

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


def _write_kv(k_cache, v_cache, k, v, pos_b, active):
    """Write this token's K/V row in place at slot ``min(pos, T-1)``;
    rows with ``active == False`` write back what is there."""
    B, T = k_cache.shape[0], k_cache.shape[1]
    rows = torch.arange(B, device=k_cache.device)
    slot_b = torch.clamp(pos_b, max=T - 1)
    k_new, v_new = k[:, 0].to(k_cache.dtype), v[:, 0].to(v_cache.dtype)
    if active is not None:
        keep = active[:, None, None]
        k_new = torch.where(keep, k_new, k_cache[rows, slot_b])
        v_new = torch.where(keep, v_new, v_cache[rows, slot_b])
    k_cache[rows, slot_b] = k_new
    v_cache[rows, slot_b] = v_new


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
    cache). Global attention only in this slice."""
    if window is not None:
        raise NotImplementedError(
            "sliding-window decode comes with the gemma3 slice (ROADMAP A8)"
        )
    B = x.shape[0]
    k_cache, v_cache = cache
    T = k_cache.shape[1]
    pos_b = _positions(pos, B, x.device)
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, pos_b[:, None],
                           theta, eps, rope_freqs)
    _write_kv(k_cache, v_cache, k, v, pos_b, active)
    G = n_heads // n_kv
    scale = 1.0 / np.sqrt(head_dim)
    qg = q.reshape(B, 1, n_kv, G, head_dim)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k_cache).reshape(B, n_heads, 1, T)
    s = s.float() * scale
    idx = torch.arange(T, device=x.device)[None, None, None, :]
    mask = idx <= pos_b[:, None, None, None]
    s = torch.where(mask, s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(x.dtype)
    pr = probs.reshape(B, n_kv, G, 1, T)
    out = torch.einsum("bkgst,btkd->bskgd", pr, v_cache)
    out = out.reshape(B, 1, n_heads * head_dim)
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
    ``lengths = min(pos+1, T)``. Window layers fall back to the plain
    decode, as in the reference."""
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
    _write_kv(k_cache, v_cache, k, v, pos_b, active)
    G = n_heads // n_kv
    q_k = q.reshape(B, n_kv, G, head_dim)
    lengths = torch.clamp(pos_b + 1, max=T).to(torch.int32)
    o = flash_decode(q_k, k_cache, v_cache, lengths)
    out = o.reshape(B, 1, n_heads * head_dim)
    return out @ p["wo"], (k_cache, v_cache)
