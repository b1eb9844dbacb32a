"""GQA attention: chunked-causal prefill and single-token cached decode.

Port of the reference's ``models/attention.py``:

* ``_project_qkv`` — q/k/v projections, qk-norm BEFORE RoPE (Qwen3,
  gemma3);
* ``attn_prefill`` — causal (optionally windowed) attention over a whole
  sequence with the reference's query chunking (``attention.py:78-189``);
  its ``lax.map`` over the chunks is a Python loop here. A sliding-window
  layer returns a RING-BUFFER cache of ``window`` positions, rolled so
  that slot = position % window;
* ``attn_decode`` — the plain attention, kept for parity tests
  (``attention.py:192-242``). A window layer writes its ring at
  ``pos % T`` and masks each slot by the position it holds;
* ``cross_attn`` and ``encode_kv`` — the enc-dec family's attention over
  the encoder output (``attention.py:292-320``);
* ``attn_decode_kernel`` — the counterpart of the reference's
  ``attn_decode_kernel`` (``attention.py:245-289``): the same K/V write,
  then the ``repro_torch::flash_decode`` op as the attention core. This
  is the attention of the served decode step on every layer, global or
  window. The reference sends window layers to the plain decode; here a
  ring of ``T <= window`` slots is read by the kernel at ``lengths =
  min(pos + 1, T)``, which is the ring mask: slot i holds position
  ``pos - ((pos - i) mod T)``, which lies in ``(pos - T, pos]``, so it is
  within the window whenever it is ``>= 0``, and it is ``>= 0`` exactly
  when ``i < min(pos + 1, T)``. In a sharded step whose cache has its T
  split over ranks (the ``kv_heads`` rule where K/V heads do not divide
  ``model``), each rank runs the kernel on its span and the ranks'
  outputs merge by their log-sum-exps (``flash_decode_context_parallel``).

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

A layer's cache, global or ring, may also be PAGED
(``models/paged.PagedLeaf``: the engine's page pool, its page table and
the leaf's address in a slot region). The write then goes through the
table (``_write_kv_paged``), the kernel core is
``repro_torch::flash_decode_paged``, and the plain core attends over the
rows gathered through the table.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_lse,
                                              flash_decode_paged)
from repro_torch.models.layers import init_linear, init_rms, rms_norm, rope
from repro_torch.models.paged import PagedLeaf, kv_rows

NEG_INF = -1e30
# the attention cores taken, one per layer call: "kernel" (flash_decode,
# also on a shard), "kernel: context-parallel" (flash_decode_lse on each
# rank's span of T, merged across the ranks) or "plain" (attn_prefill,
# attn_decode); a sharded step's report reads them (launch/dryrun)
CORES: collections.Counter = collections.Counter()


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
    if is_dtensor(k_cache):
        _write_kv_sharded(k_cache, v_cache, k, v, slot_b, active)
        return
    B = k_cache.shape[0]
    rows = torch.arange(B, device=k_cache.device)
    k_new, v_new = k[:, 0].to(k_cache.dtype), v[:, 0].to(v_cache.dtype)
    if active is not None:
        keep = active[:, None, None]
        k_new = torch.where(keep, k_new, k_cache[rows, slot_b])
        v_new = torch.where(keep, v_new, v_cache[rows, slot_b])
    k_cache[rows, slot_b] = k_new
    v_cache[rows, slot_b] = v_new


def _write_kv_sharded(k_cache, v_cache, k, v, slot_b, active):
    """``_write_kv`` on DTensor caches (a sharded step), in place on each
    rank's shard. The new rows, their slots and the active mask are
    brought to the cache's batch and head shards; a cache whose T is
    split over ``model`` (context parallel) takes a row only on the rank
    whose span holds its slot, and the other ranks write back what they
    hold."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, pl = k_cache.device_mesh, k_cache.placements
    # a cache dim's shard on the (B, KV, hd) rows: batch, heads, head dim
    row_dim = {0: 0, 2: 1, 3: 2}
    row_pl = tuple(Shard(row_dim[p.dim]) if p.is_shard() and p.dim in row_dim
                   else Replicate() for p in pl)
    vec_pl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)

    def local(t, placements):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, placements).to_local()

    slots = local(slot_b, vec_pl)
    kl, vl = k_cache.to_local(), v_cache.to_local()
    Tl = kl.shape[1]
    slots = slots - _t_span(mesh, pl) * Tl
    mine = (slots >= 0) & (slots < Tl)
    if active is not None:
        mine = mine & local(active, vec_pl)
    slots = torch.clamp(slots, 0, Tl - 1)
    rows = torch.arange(kl.shape[0], device=kl.device)
    keep = mine[:, None, None]
    for cache_l, new in ((kl, k), (vl, v)):
        new_l = local(new[:, 0].to(cache_l.dtype), row_pl)
        cache_l[rows, slots] = torch.where(keep, new_l, cache_l[rows, slots])


def _t_span(mesh, placements) -> int:
    """Which span of a cache's T this rank holds: its coordinates on the
    mesh dims that split T (dim 1), in mesh order; 0 where none does."""
    span, coord = 0, mesh.get_coordinate()
    for m, p in enumerate(placements):
        if p.is_shard(1):
            span = span * mesh.size(m) + coord[m]
    return span


def flash_decode_context_parallel(q, k_cache, v_cache, lengths):
    """``flash_decode`` over DTensor caches whose T is split over mesh
    dims (context parallel). Each rank runs ``flash_decode_lse`` on its
    own span of positions, its lengths cut to the span (0 where the row
    has not reached it), and the ranks' outputs merge by their
    log-sum-exps: an all-reduce max of the lse over the dims that split
    T, then one all-reduce sum of ``o · exp(lse - max)`` with the weights
    beside it, and the quotient. q ``(B, KV, G, D)`` and lengths come to
    the cache's batch and head shards. Returns a DTensor in q's dtype."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, pl = k_cache.device_mesh, k_cache.placements
    q_pl = tuple(Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2)
                 else Replicate() for p in pl)
    len_pl = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)
    t_dims = [m for m, p in enumerate(pl) if p.is_shard(1)]

    def local(t, placements):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, placements).to_local()

    kl, vl = k_cache.to_local(), v_cache.to_local()
    Tl = kl.shape[1]
    ql = local(q, q_pl).contiguous()
    start = _t_span(mesh, pl) * Tl
    len_l = torch.clamp(local(lengths, len_pl) - start, 0, Tl).to(torch.int32)
    o, lse = flash_decode_lse(ql, kl, vl, len_l)
    top = lse
    for m in t_dims:
        top = funcol.all_reduce(top, "max", (mesh, m))
    w = torch.exp(lse - top)[..., None]
    part = torch.cat([o.float() * w, w], dim=-1)
    for m in t_dims:
        part = funcol.all_reduce(part, "sum", (mesh, m))
    out = (part[..., :-1] / part[..., -1:]).to(ql.dtype)
    shape = tuple(q.shape)
    stride = tuple(int(math.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(out, mesh, q_pl, run_check=False, shape=shape,
                              stride=stride)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (a sharded step's tensor); the import
    waits until a DTensor can exist."""
    if type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def context_parallel(cache: torch.Tensor) -> bool:
    """Whether a DTensor K/V cache has its T dim split over a mesh dim
    (the ``kv_heads`` rule's context parallelism): no rank holds a whole
    row of positions, so the ranks' partial softmaxes must be merged
    (``flash_decode_context_parallel``)."""
    return is_dtensor(cache) and any(p.is_shard(1) for p in cache.placements)


def _write_kv_paged(k_cache: PagedLeaf, v_cache: PagedLeaf, k, v, slot_b, active):
    """``_write_kv`` through the page table: each row's physical elements
    come from the table and the leaves' addresses (``kv_rows``), and every
    row writes ``where(active, new, old)`` with ``old`` read through the
    table. An inactive slot's row may resolve to the null page (an entry
    of a retired slot whose page another slot took, or of a slot never
    mapped); the null page is all zeros, so such a row reads zeros and
    writes them back, and the duplicate indices ``index_put_`` gets there
    all carry the same zeros. An active slot's rows lie in pages its
    admission mapped, which no other slot maps."""
    buf = k_cache.buf
    idx = kv_rows(k_cache, v_cache, slot_b)  # (B, 2, KV·D)
    new = torch.stack([k[:, 0], v[:, 0]], dim=1).reshape(idx.shape).to(buf.dtype)
    if active is not None:
        new = torch.where(active[:, None, None], new, buf[idx])
    buf[idx] = new


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
    constrain=None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Causal (optionally windowed) attention over the full sequence.
    Returns (out (B,S,D), (k_cache, v_cache)): the whole K/V for a global
    layer, the ring of the last ``window`` positions for a window layer.

    The query chunking is the reference's, so a traced prefill holds
    tensors of the reference's sizes: for S <= 8192 without a window,
    ``q_chunk = max(q_chunk, ceil(S/16))`` and chunk i attends keys
    ``[0, (i+1)·C)``; with a window, each chunk attends a key slice of
    ``Lk = min(S, (ceil((W-1)/C)+1)·C)`` positions; longer causal
    sequences mask a full (C, S) tile per chunk; S <= C is one chunk.
    Where the keys are split on T over the ranks of a sharded step
    (``context_parallel``: the ``kv_heads`` rule, K/V heads that do not
    divide ``model``), every chunk masks the whole tile, window or not."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, positions, theta,
                           eps, rope_freqs)
    if constrain is not None:
        q = constrain(q, "heads")
        k = constrain(k, "kv_heads")
        v = constrain(v, "kv_heads")
    CORES["plain"] += 1
    scale = 1.0 / np.sqrt(head_dim)
    # keys split on T: a key slice of a chunk cannot be split evenly over
    # the ranks, so each rank masks its whole span (launch/mesh.ShardedOps
    # reduces the softmax and the PV product across the ranks)
    whole_tile = context_parallel(k)
    causal_unroll = window is None and S <= 8192 and not whole_tile
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
    if window is not None and S > C and not whole_tile:
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
        # long-S causal, or keys split on T: every chunk masks the whole
        # (C, S) tile
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


def _slot(pos_b, T: int, window: int | None) -> torch.Tensor:
    """Where each row's new K/V goes: ``pos % T`` on a ring, else
    ``min(pos, T - 1)``."""
    return pos_b % T if window is not None else torch.clamp(pos_b, max=T - 1)


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
    constrain=None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One-token decode with the plain attention; returns (out (B,1,D),
    cache). A window layer's cache is a ring of T slots: it writes slot
    ``pos % T``, and slot i, which holds the largest position p <= pos
    with p % T == i, is read when ``pos - window < p``."""
    B = x.shape[0]
    k_cache, v_cache = cache
    paged = isinstance(k_cache, PagedLeaf)
    T = k_cache.shape[0] if paged else k_cache.shape[1]
    pos_b = _positions(pos, B, x.device)
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, pos_b[:, None],
                           theta, eps, rope_freqs)
    slot_b = _slot(pos_b, T, window)
    if paged:
        _write_kv_paged(k_cache, v_cache, k, v, slot_b, active)
        k_read, v_read = k_cache.gather(), v_cache.gather()
    else:
        _write_kv(k_cache, v_cache, k, v, slot_b, active)
        k_read, v_read = k_cache, v_cache
    if constrain is not None:
        k_read = constrain(k_read, "kv_heads")
        v_read = constrain(v_read, "kv_heads")
    out = decode_attention(q, k_read, v_read, pos_b, window)  # (B,1,H*D)
    CORES["plain"] += 1
    return out @ p["wo"], (k_cache, v_cache)


def decode_attention(q, k, v, pos_b, window: int | None) -> torch.Tensor:
    """The plain attention core of one decode token: q (B,1,H,D) over the
    cache k/v (B,T,KV,D) at positions ``pos_b`` (B,), the reference's
    masks: slots ``<= pos`` on a global cache, and on a ring slot i, which
    holds position ``pos - ((pos - i) mod T)``, when that position is
    ``>= 0`` and inside the window. Returns (B,1,H·D)."""
    T = k.shape[1]
    s = _gqa_scores(q, k).float() * (1.0 / np.sqrt(q.shape[-1]))  # (B,H,1,T)
    idx = torch.arange(T, device=q.device)[None, None, None, :]
    pb = pos_b[:, None, None, None]
    if window is None:
        mask = idx <= pb
    else:
        # a floor modulo (the tensor %): pb - idx < 0 on half the ring
        slot_pos = pb - ((pb - idx) % T)
        mask = (slot_pos >= 0) & (slot_pos <= pb) & (slot_pos > pb - window)
    s = torch.where(mask, s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return _gqa_out(probs, v)


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
    constrain=None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """``attn_decode`` with ``repro_torch::flash_decode`` as the attention
    core: the K/V write, then single-pass attention over the cache at
    ``lengths = min(pos+1, T)``, on a global layer and on a ring alike
    (a ring of ``T <= window`` slots: the module docstring shows that
    these lengths are the ring mask). A paged cache is written through
    the table and read by ``repro_torch::flash_decode_paged``."""
    B = x.shape[0]
    k_cache, v_cache = cache
    paged = isinstance(k_cache, PagedLeaf)
    T = k_cache.shape[0] if paged else k_cache.shape[1]
    if window is not None and T > window:
        raise ValueError(f"a ring of {T} slots is longer than its window {window}: "
                         f"the kernel's lengths would read positions out of it")
    pos_b = _positions(pos, B, x.device)
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, pos_b[:, None],
                           theta, eps, rope_freqs)
    slot_b = _slot(pos_b, T, window)
    G = n_heads // n_kv
    q_k = q.reshape(B, n_kv, G, head_dim)
    lengths = torch.clamp(pos_b + 1, max=T).to(torch.int32)
    if paged:
        _write_kv_paged(k_cache, v_cache, k, v, slot_b, active)
        st, sh, _ = k_cache.strides
        o = flash_decode_paged(q_k, k_cache.buf, k_cache.table, k_cache.offset,
                               v_cache.offset, st, sh, T, k_cache.page_elems,
                               lengths)
        CORES["kernel"] += 1
    else:
        _write_kv(k_cache, v_cache, k, v, slot_b, active)
        k_read, v_read = k_cache, v_cache
        if constrain is not None:
            k_read = constrain(k_read, "kv_heads")
            v_read = constrain(v_read, "kv_heads")
        if context_parallel(k_read):
            # chosen from the placements: T is split over the ranks
            o = flash_decode_context_parallel(q_k, k_read, v_read, lengths)
            CORES["kernel: context-parallel"] += 1
        else:
            o = flash_decode(q_k, k_read, v_read, lengths)
            CORES["kernel"] += 1
    out = o.reshape(B, 1, n_heads * head_dim)
    return out @ p["wo"], (k_cache, v_cache)


def cross_attn_init(generator, lead: tuple[int, ...], d_model: int, n_heads: int,
                    n_kv: int, head_dim: int, dtype, device) -> dict:
    return attn_init(generator, lead, d_model, n_heads, n_kv, head_dim, False,
                     dtype, device)


def cross_attn(
    p: dict,
    x: torch.Tensor,  # (B, S, D) decoder side
    enc_kv: tuple[torch.Tensor, torch.Tensor],  # precomputed (B, T, KV, hd) x2
    *,
    n_heads: int,
    head_dim: int,
    constrain=None,
) -> torch.Tensor:
    """Attention of the decoder's positions over the encoder's K/V, no
    mask and no RoPE (reference ``attention.py:296-312``)."""
    B, S, _ = x.shape
    k, v = enc_kv
    q = (x @ p["wq"]).reshape(B, S, n_heads, head_dim)
    if constrain is not None:
        q = constrain(q, "heads")
    s = _gqa_scores(q, k).float() / np.sqrt(head_dim)
    probs = torch.softmax(s, dim=-1).to(x.dtype)
    return _gqa_out(probs, v) @ p["wo"]


def encode_kv(p: dict, enc_out: torch.Tensor, n_kv: int, head_dim: int):
    """Project the encoder output once into cross-attention K/V."""
    B, T, _ = enc_out.shape
    k = (enc_out @ p["wk"]).reshape(B, T, n_kv, head_dim)
    v = (enc_out @ p["wv"]).reshape(B, T, n_kv, head_dim)
    return k, v
