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


def flash_decode_lse_ref(q, k_cache, v_cache, lengths
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_decode_ref``'s output and each query head's log-sum-exp
    ``m + log(l)`` of its scores (fp32 ``(B, KV, G)``), as the kernel
    merges them: a row with no position (``lengths`` 0) gives the output
    0 and the log-sum-exp -1e30."""
    D = q.shape[-1]
    T = k_cache.shape[1]
    s = torch.einsum("bkgd,btkd->bkgt", q.float() * (1.0 / D ** 0.5), k_cache.float())
    mask = torch.arange(T, device=q.device) < lengths[:, None, None, None]
    s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    l = e.sum(dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", e, v_cache.float())
    o = o / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m[..., 0] + torch.log(torch.clamp(l, min=1e-30)), -1e30)
    return o.to(q.dtype), lse


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


def _work(x: torch.Tensor) -> torch.dtype:
    """The dtype the SSD chunk computes in: float32, or float64 for
    float64 inputs (the CPU's gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


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
    ~1e-14 of it, far below one float32 rounding. Float64 inputs are
    computed in float64 throughout."""
    L = x.shape[1]
    f = _work(x)
    cum = torch.cumsum(dA.double(), dim=1)  # (B,L,H)
    total = cum[:, -1]  # (B,H)
    seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Lq,Lk,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(causal[None, :, :, None], seg, -torch.inf).to(f))
    qk = torch.einsum("blhn,bmhn->blmh", Cm.to(f), Bm.to(f))
    W = qk * decay * dt[:, None, :, :]
    y_intra = torch.einsum("blmh,bmhp->blhp", W, x.to(f))
    y_inter = torch.einsum(
        "blhn,bhpn->blhp",
        Cm.to(f) * torch.exp(cum.to(f))[..., None],
        state.to(f),
    )
    rem = torch.exp((total[:, None, :] - cum).to(f)) * dt  # (B,L,H)
    dBx = torch.einsum(
        "blhn,blhp->bhpn", Bm.to(f) * rem[..., None], x.to(f),
    )
    new_state = state.to(f) * torch.exp(total.to(f))[..., None, None] + dBx
    return (y_intra + y_inter).to(x.dtype), new_state.to(state.dtype)


def ssd_chunk_bwd_ref(
    x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, state: torch.Tensor,
    dy: torch.Tensor,  # (B, L, H, P) gradient of y
    dnew_state: torch.Tensor,  # (B, H, P, N) gradient of new_state
) -> tuple[torch.Tensor, ...]:
    """The backward of one SSD chunk, the analytic VJP of ``ssd_chunk_ref``
    written out: (dx, ddt, ddA, dBm, dCm, dstate), each in its input's
    dtype. With S = C Bᵀ, decay_ij = exp(cum_i - cum_j) for i >= j (0
    above the diagonal), W = S ⊙ decay ⊙ dt_j, rem_j = exp(total - cum_j)
    dt_j:

    * dW = dy xᵀ, dS = dW ⊙ decay ⊙ dt_j, H = dW ⊙ S ⊙ decay;
    * dx = Wᵀ dy + rem ⊙ (B dnsᵀ), dC = dS B + e^{cum} (dy state),
      dB = dSᵀ C + rem ⊙ (x dns), dstate = e^{total} dns + Σ_i e^{cum_i}
      dy_iᵀ C_i;
    * ddt_j = Σ_i H_ij + e^{total - cum_j} drem_j, with drem_j = x_j ·
      (B_j dnsᵀ);
    * dcum_i collects the decays (Σ_j H_ij dt_j - Σ_k H_ki dt_i), e^{cum}
      (dy_i · y_inter_i), e^{total - cum} (-drem_i rem_i) and, at the
      last position, total's (Σ_j drem_j rem_j + e^{total} Σ state ⊙
      dns); ddA is its reverse cumulative sum, in float64 as the forward
      takes its prefix sum. The masked decays are exact zeros, so no
      0·inf reaches dcum."""
    L = x.shape[1]
    f = _work(x)
    x_, B_, C_, s_ = x.to(f), Bm.to(f), Cm.to(f), state.to(f)
    dy_, dns = dy.to(f), dnew_state.to(f)
    dt_ = dt.to(f)
    cum = torch.cumsum(dA.double(), dim=1)  # (B,L,H)
    total = cum[:, -1]  # (B,H)
    seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Lq,Lk,H)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(causal[None, :, :, None], seg, -torch.inf).to(f))
    S = torch.einsum("blhn,bmhn->blmh", C_, B_)
    W = S * decay * dt_[:, None, :, :]
    ecum = torch.exp(cum.to(f))  # (B,L,H)
    erem = torch.exp((total[:, None, :] - cum).to(f))  # (B,L,H)
    rem = erem * dt_
    etot = torch.exp(total.to(f))  # (B,H)

    dW = torch.einsum("blhp,bmhp->blmh", dy_, x_)
    dS = dW * decay * dt_[:, None, :, :]
    Hm = dW * S * decay  # d(loss)/d(dt_j) through W, per (i, j)
    Bdns = torch.einsum("bmhn,bhpn->bmhp", B_, dns)  # (B,L,H,P)
    dx = torch.einsum("blmh,blhp->bmhp", W, dy_) + rem[..., None] * Bdns
    dC = (torch.einsum("blmh,bmhn->blhn", dS, B_)
          + ecum[..., None] * torch.einsum("blhp,bhpn->blhn", dy_, s_))
    dB = (torch.einsum("blmh,blhn->bmhn", dS, C_)
          + rem[..., None] * torch.einsum("bmhp,bhpn->bmhn", x_, dns))
    drem = (x_ * Bdns).sum(-1)  # (B,L,H)
    ddt = Hm.sum(1) + drem * erem
    G = Hm * dt_[:, None, :, :]  # d(loss)/d(cum_i - cum_j)
    inter = ecum * (dy_ * torch.einsum("blhn,bhpn->blhp", C_, s_)).sum(-1)
    dcum = (G.sum(2) - G.sum(1) + inter - drem * rem).double()
    dtotal = (drem * rem).sum(1) + etot * (s_ * dns).sum((-1, -2))  # (B,H)
    dcum[:, -1] += dtotal.double()
    ddA = torch.flip(torch.cumsum(torch.flip(dcum, [1]), dim=1), [1])
    dstate = (etot[..., None, None] * dns
              + torch.einsum("blhp,blhn->bhpn", dy_ * ecum[..., None], C_))
    return (dx.to(x.dtype), ddt.to(dt.dtype), ddA.to(dA.dtype), dB.to(Bm.dtype),
            dC.to(Cm.dtype), dstate.to(state.dtype))


# ssd_chunk_bwd against its plain version computed in float64 on the same
# inputs, as atol + rtol·scale by the output's dtype: fp32 summation order,
# and one rounding of a bf16 output (2**-8 of it). The scale is |want|,
# except for ddA: ddA_k sums dcum_i over i >= k, and dcum_i is itself a
# difference of the decays' row and column sums, so ddA cancels; its scale
# is what it sums, sum_{i>=k} |dcum_i| (``ssd_chunk_bwd_scale``).
SSD_BWD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-4, 1e-4 + 2.0**-8)}


def ssd_chunk_bwd_scale(name: str, want: torch.Tensor, L: int) -> torch.Tensor:
    """The scale of the summation error of the gradient ``name`` (dx, ddt,
    ddA, dB, dC, dstate; dA for ddA): |want|, and for ddA, within each
    chunk of L positions (axis 1), sum_{i>=k} |dcum_i| with dcum_i =
    ddA_i - ddA_{i+1} (at a chunk's last position ddA itself)."""
    if name not in ("ddA", "dA"):
        return want.abs()
    parts = []
    for c in want.split(L, dim=1):
        d = c.clone()
        d[:, :-1] -= c[:, 1:]
        parts.append(torch.flip(torch.cumsum(torch.flip(d.abs(), [1]), 1), [1]))
    return torch.cat(parts, dim=1)


def ssd_chunk_bwd_tolerance(name: str, got: torch.Tensor, want: torch.Tensor, L: int,
                            tol: tuple[float, float] | None = None) -> float:
    """max |got - want| / (atol + rtol·scale) over the elements of the
    gradient ``name``: at most 1 is within the bar. ``tol`` is (atol, rtol),
    ``SSD_BWD_TOL`` of got's dtype unless given; ``want`` is the plain
    backward's in float64."""
    atol, rtol = SSD_BWD_TOL[got.dtype] if tol is None else tol
    want = want.double()
    err = (got.detach().double() - want).abs()
    return float((err / (atol + rtol * ssd_chunk_bwd_scale(name, want, L))).max())
