"""Plain PyTorch versions of the port's kernels (twins of the reference's
``kernels/ref.py``). The tests hold them against the JAX oracles; on the
card ``chip_smoke.py`` holds each kernel against its plain version. The
attention uses them only for tensors that lie on the CPU."""

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
