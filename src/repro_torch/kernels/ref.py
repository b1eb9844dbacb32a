"""Plain PyTorch versions of the port's kernels (twins of the reference's
``kernels/ref.py``). The tests hold them against the JAX oracles; on the
card ``chip_smoke.py`` holds each kernel against its plain version. The
model uses them only for tensors that lie on the CPU, or when a parity
check asks for the plain core."""

from __future__ import annotations

import torch


def flash_decode_ref(
    q: torch.Tensor,  # (B, KV, G, D)
    k_cache: torch.Tensor,  # (B, T, KV, D)
    v_cache: torch.Tensor,  # (B, T, KV, D)
    lengths: torch.Tensor,  # (B,)
) -> torch.Tensor:
    B, KV, G, D = q.shape
    T = k_cache.shape[1]
    scale = 1.0 / (D ** 0.5)
    s = torch.einsum("bkgd,btkd->bkgt", q.float() * scale, k_cache.float())
    mask = (
        torch.arange(T, device=q.device)[None, None, None, :]
        < lengths[:, None, None, None]
    )
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", p, v_cache.float())
    return o.to(q.dtype)


def paged_index(table: torch.Tensor, offset, strides: tuple[int, ...],
                shape: tuple[int, ...], page_elems: int) -> torch.Tensor:
    """Physical element indices of a paged cache into the buffer viewed as
    the cache dtype: element ``(i, j, ...)`` of slot ``b`` is the slot
    region's logical element ``e = o + i·strides[0] + j·strides[1] + ...``,
    which lies at ``table[b, e // page_elems] · page_elems + e %
    page_elems``. ``offset`` is one int ``o`` for every slot, giving
    ``(B, *shape)``, or an integer tensor ``(B, *lead)`` of per-slot
    offsets, giving ``(B, *lead, *shape)``."""
    dev = table.device
    B = table.shape[0]
    if not isinstance(offset, torch.Tensor):
        offset = torch.full((1,), offset, dtype=torch.int64, device=dev)
    e = offset.reshape(offset.shape + (1,) * len(shape))
    for axis, (n, s) in enumerate(zip(shape, strides)):
        view = [1] * len(shape)
        view[axis] = n
        step = torch.arange(n, device=dev)
        e = e + (step if s == 1 else step * s).reshape(view)  # no kernel for a * 1
    e = e.expand((B,) + e.shape[1:])
    page = e // page_elems
    phys = torch.gather(table, 1, page.reshape(B, -1)).reshape(e.shape)
    return e + (phys - page) * page_elems


def flash_decode_paged_ref(
    q: torch.Tensor,  # (B, KV, G, D)
    buf: torch.Tensor,  # the physical buffer viewed as the cache dtype, 1-D
    table: torch.Tensor,  # (B, pages_per_slot) int32
    k_offset: int,
    v_offset: int,
    pos_stride: int,
    head_stride: int,
    t_len: int,
    page_elems: int,
    lengths: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """``flash_decode_ref`` on the (B, T, KV, D) K and V gathered through
    the page table (offsets, strides and the page size in elements of
    the cache dtype)."""
    _, KV, _, D = q.shape
    shape, strides = (t_len, KV, D), (pos_stride, head_stride, 1)
    k = buf[paged_index(table, k_offset, strides, shape, page_elems)]
    v = buf[paged_index(table, v_offset, strides, shape, page_elems)]
    return flash_decode_ref(q, k, v, lengths)


def ssd_chunk_ref(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) fp32 (already softplus'd)
    dA: torch.Tensor,  # (B, L, H) fp32 (dt * A, negative)
    Bm: torch.Tensor,  # (B, L, H, N) — B projected, broadcast to heads
    Cm: torch.Tensor,  # (B, L, H, N)
    state: torch.Tensor,  # (B, H, P, N) incoming inter-chunk state
) -> tuple[torch.Tensor, torch.Tensor]:
    """One SSD chunk: returns (y (B,L,H,P), new_state (B,H,P,N)).

    The reference's line for line, with one departure: the prefix sum of
    dA and its differences are taken in float64 and rounded to float32
    before ``exp``. At |cum| ~ 180 (L = 256 positions of dA ~ -0.7) an
    fp32 prefix sum carries ~1e-5 of error into every decay, as much as
    the whole fp32 tolerance of the comparison. The CUDA kernel sums in
    float64 too, in another order; in float64 the order moves the sum by
    ~1e-14 of it, far below one float32 rounding."""
    L = x.shape[1]
    cum = torch.cumsum(dA.double(), dim=1)  # (B,L,H)
    total = cum[:, -1]  # (B,H)
    seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Lq,Lk,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(causal[None, :, :, None], seg, -torch.inf).float())
    qk = torch.einsum("blhn,bmhn->blmh", Cm.float(), Bm.float())
    W = qk * decay * dt[:, None, :, :]
    y_intra = torch.einsum("blmh,bmhp->blhp", W, x.float())
    y_inter = torch.einsum(
        "blhn,bhpn->blhp",
        Cm.float() * torch.exp(cum.float())[..., None],
        state.float(),
    )
    rem = torch.exp((total[:, None, :] - cum).float()) * dt  # (B,L,H)
    dBx = torch.einsum(
        "blhn,blhp->bhpn", Bm.float() * rem[..., None], x.float(),
    )
    new_state = state.float() * torch.exp(total.float())[..., None, None] + dBx
    return (y_intra + y_inter).to(x.dtype), new_state.to(state.dtype)
