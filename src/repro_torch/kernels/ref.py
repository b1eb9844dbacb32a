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
