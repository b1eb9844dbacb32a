"""Shared neural-net layers (plain functions over param dicts).

Port of the reference's ``models/layers.py`` with its cast points kept
exactly: ``rms_norm`` computes in fp32 with ``(1 + scale)``, ``rope``
rotates the two halves (not interleaved) with angles in fp32, and
``init_linear`` draws U(±1/√d_in) in a (d_in, d_out) layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def init_rms(d: int, device, lead: tuple[int, ...] = ()) -> torch.Tensor:
    return torch.zeros((*lead, d), dtype=torch.float32, device=device)


def rope_freqs(d: int, theta: float) -> np.ndarray:
    """The rotary frequencies, computed in numpy float32 exactly as the
    reference computes them (they are trace-time constants there)."""
    half = d // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


def rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float = 10_000.0,
    freqs: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: broadcastable to
    (..., S). ``freqs`` is ``rope_freqs(D, theta)`` already on x's device
    (the model keeps one; building it here costs a host-to-device copy,
    which on CUDA waits for the stream)."""
    d = x.shape[-1]
    half = d // 2
    if freqs is None:
        freqs = torch.from_numpy(rope_freqs(d, theta)).to(x.device)
    angles = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half : 2 * half]
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    out = torch.cat([rot1, rot2, x[..., 2 * half :].to(rot1.dtype)], dim=-1)
    return out.to(x.dtype)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "sq_relu":  # Nemotron-4 (arXiv:2402.16819)
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name}")


def init_linear(
    generator: torch.Generator, shape: tuple[int, ...], dtype: torch.dtype, device
) -> torch.Tensor:
    """U(±1/√d_in) with ``shape[-2:] == (d_in, d_out)``; leading axes stack
    independent draws (the n_periods axis of scanned period params). On
    the ``meta`` device nothing is drawn."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    scale = 1.0 / np.sqrt(shape[-2])
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u * (2 * scale) - scale).to(device=device, dtype=dtype)


def mlp_init(generator, lead: tuple[int, ...], d_model: int, d_ff: int, act: str,
             dtype, device) -> dict:
    p = {"w_out": init_linear(generator, (*lead, d_ff, d_model), dtype, device)}
    p["w_in"] = init_linear(generator, (*lead, d_model, d_ff), dtype, device)
    if act != "sq_relu":  # gated (SwiGLU/GeGLU); Nemotron style has no gate
        p["w_gate"] = init_linear(generator, (*lead, d_model, d_ff), dtype, device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    f = activation(act)
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = f(x @ p["w_gate"]) * h
    else:
        h = f(h)
    return h @ p["w_out"]
