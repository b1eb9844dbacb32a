"""Mamba2 block via SSD (state-space duality, arXiv:2405.21060).

Port of the reference's ``models/ssm.py``. Prefill uses the chunked SSD
algorithm: the reference carries the state across chunks with a
``lax.scan`` whose body computes one chunk; here a Python loop over the
chunks calls ``repro_torch::ssd_chunk`` once per chunk (the hand-written
kernel on the card). Decode is the O(1) recurrent update on the
(B, H, P, N) state, written IN PLACE into the caches, which are views
into the serving engine's one state buffer.

Block layout follows Mamba2: in_proj -> [z | xBC | dt], causal depthwise
conv over xBC, SSD core, gated RMSNorm, out_proj. Decode carries
(conv_state (B, K-1, conv_dim), ssm_state (B, H, P, N)). The cast points
are the reference's; ``A_log``, ``D``, ``dt_bias`` and ``norm`` are fp32
among weights of the model's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import ssd_chunk_ref
from repro_torch.kernels.ssd_chunk import ssd_chunk
from repro_torch.models.layers import init_linear, init_rms, rms_norm

# the SSD core of mamba_prefill, by ``cores``: the kernel op (served) or
# its plain version (parity checks on the card)
SSD = {"kernel": ssd_chunk, "plain": ssd_chunk_ref}


def ssm_dims(d_model: int, expand: int, head_dim: int, ngroups: int, dstate: int):
    d_inner = expand * d_model
    nheads = d_inner // head_dim
    conv_dim = d_inner + 2 * ngroups * dstate
    return d_inner, nheads, conv_dim


def mamba_init(generator, lead: tuple[int, ...], d_model: int, *, expand: int,
               head_dim: int, ngroups: int, dstate: int, conv: int, dtype,
               device) -> dict:
    """The reference's distributions (``ssm.py:33-46``); leading axes
    ``lead`` stack independent layers."""
    d_inner, nheads, conv_dim = ssm_dims(d_model, expand, head_dim, ngroups, dstate)
    meta = torch.device(device).type == "meta"
    if meta:
        conv_w = torch.empty((*lead, conv, conv_dim), dtype=dtype, device=device)
    else:
        conv_w = (torch.randn((*lead, conv, conv_dim), generator=generator,
                              dtype=torch.float32, device=generator.device)
                  * 0.1).to(device=device, dtype=dtype)
    a_log = torch.log(torch.linspace(1.0, 16.0, nheads, dtype=torch.float32,
                                     device=device))
    return {
        "in_proj": init_linear(
            generator, (*lead, d_model, 2 * d_inner + 2 * ngroups * dstate + nheads),
            dtype, device,
        ),
        "conv_w": conv_w,
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dtype, device=device),
        "A_log": a_log.expand(*lead, nheads).clone(),
        "D": torch.ones((*lead, nheads), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((*lead, nheads), dtype=torch.float32, device=device),
        "norm": init_rms(d_inner, device, lead),
        "out_proj": init_linear(generator, (*lead, d_inner, d_model), dtype, device),
    }


def _split_proj(dims: dict, zxbcdt: torch.Tensor):
    d_inner, ngroups, dstate = dims["d_inner"], dims["ngroups"], dims["dstate"]
    xbc_end = 2 * d_inner + 2 * ngroups * dstate
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:xbc_end],
            zxbcdt[..., xbc_end:])


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d. xBC: (B, S, C); w: (K, C). The taps are
    summed one by one in the reference's order (a cuDNN conv1d would run
    fp32 in TF32 on the card)."""
    K = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(K):  # K is small (4); unrolled taps
        out = out + pad[:, i : i + S] * w[i]
    return F.silu(out + b)


def _heads(t: torch.Tensor, nheads: int) -> torch.Tensor:
    """(B, S, G, N) groups -> (B, S, H, N) heads, as the reference's
    ``jnp.repeat`` over the group axis. One group reaches every head
    through a head stride of 0 (no copy)."""
    B, S, G, N = t.shape
    if G == 1:
        return t.expand(B, S, nheads, N)
    return t.repeat_interleave(nheads // G, dim=2)


def mamba_prefill(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    *,
    expand: int,
    head_dim: int,
    ngroups: int,
    dstate: int,
    conv: int,
    chunk: int = 256,
    eps: float = 1e-6,
    cores: str = "kernel",
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns (out (B,S,D), (conv_state, ssm_state))."""
    B, S, D = x.shape
    d_inner, nheads, conv_dim = ssm_dims(D, expand, head_dim, ngroups, dstate)
    dims = dict(d_inner=d_inner, nheads=nheads, ngroups=ngroups, dstate=dstate)
    zxbcdt = x @ p["in_proj"]
    z, xBC_raw, dt = _split_proj(dims, zxbcdt)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    H, P, G, N = nheads, head_dim, ngroups, dstate
    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["A_log"])  # (H,) negative
    dA = dt * A  # (B,S,H)

    # ---- chunked SSD: pad to whole chunks (padded dt and dA are 0, so a
    # padded position leaves the state as it was); xs, B and C are views
    # into the padded conv output
    L = min(chunk, S)
    n_chunks = -(-S // L)
    pad = n_chunks * L - S
    if pad:
        xBC = F.pad(xBC, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
    xs = xBC[..., :d_inner].unflatten(-1, (H, P))
    Bh = _heads(xBC[..., d_inner : d_inner + G * N].unflatten(-1, (G, N)), H)
    Ch = _heads(xBC[..., d_inner + G * N :].unflatten(-1, (G, N)), H)

    core = SSD[cores]
    state = torch.zeros((B, H, P, N), dtype=x.dtype, device=x.device)
    ys = []
    for c in range(n_chunks):
        sl = slice(c * L, (c + 1) * L)
        y_c, state = core(xs[:, sl], dt[:, sl], dA[:, sl], Bh[:, sl], Ch[:, sl], state)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)[:, :S]
    y = y + xs[:, :S] * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, d_inner)
    y = rms_norm(y * F.silu(z), p["norm"], eps)
    out = y @ p["out_proj"]
    # a copy of the last conv - 1 rows: a view would keep the layer's whole
    # in_proj output alive for as long as the cache lives
    conv_state = xBC_raw[:, max(S - (conv - 1), 0) :].clone()
    if S < conv - 1:
        conv_state = F.pad(conv_state, (0, 0, conv - 1 - S, 0))
    return out, (conv_state, state)


def mamba_decode(
    p: dict,
    x: torch.Tensor,  # (B, 1, D)
    cache: tuple[torch.Tensor, torch.Tensor],  # conv (B,K-1,conv_dim), ssm (B,H,P,N)
    *,
    expand: int,
    head_dim: int,
    ngroups: int,
    dstate: int,
    conv: int,
    eps: float = 1e-6,
    active: torch.Tensor | None = None,  # (B,) bool — freeze inactive states
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One token; returns (out (B,1,D), cache). The cache tensors are
    written in place — rows with ``active == False`` write back what they
    hold, bit for bit — and returned."""
    B, _, D = x.shape
    d_inner, nheads, conv_dim = ssm_dims(D, expand, head_dim, ngroups, dstate)
    dims = dict(d_inner=d_inner, nheads=nheads, ngroups=ngroups, dstate=dstate)
    conv_state, state = cache
    zxbcdt = x @ p["in_proj"]  # (B,1,·)
    z, xBC_new, dt = _split_proj(dims, zxbcdt)
    window = torch.cat([conv_state, xBC_new], dim=1)  # (B,K,conv_dim), new memory
    w = p["conv_w"]  # (K, C)
    xBC = F.silu(torch.einsum("bkc,kc->bc", window, w) + p["conv_b"])[:, None]
    H, P, G, N = nheads, head_dim, ngroups, dstate
    xs = xBC[..., :d_inner].reshape(B, H, P)
    Bm = xBC[..., d_inner : d_inner + G * N].reshape(B, G, N).repeat_interleave(H // G, dim=1)
    Cm = xBC[..., d_inner + G * N :].reshape(B, G, N).repeat_interleave(H // G, dim=1)
    dt_ = F.softplus(dt[:, 0].float() + p["dt_bias"])  # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt_ * A)  # (B,H)
    new_state = (
        state * decay[..., None, None].to(state.dtype)
        + torch.einsum("bhp,bhn->bhpn", xs * dt_[..., None].to(xs.dtype), Bm)
    )
    y = torch.einsum("bhpn,bhn->bhp", new_state, Cm)
    y = y + xs * p["D"][None, :, None].to(y.dtype)
    y = y.reshape(B, 1, d_inner)
    y = rms_norm(y * F.silu(z), p["norm"], eps)
    out = y @ p["out_proj"]
    # the new conv window comes from the concatenated copy, never from a
    # shift within the cache view (copy_ between overlapping views of one
    # buffer is undefined)
    new_conv = window[:, 1:]
    if active is not None:
        new_state = torch.where(active[:, None, None, None], new_state, state)
        new_conv = torch.where(active[:, None, None], new_conv, conv_state)
    state.copy_(new_state)
    conv_state.copy_(new_conv)
    return out, (conv_state, state)
