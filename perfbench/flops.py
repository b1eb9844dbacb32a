"""Model FLOPs of one token, from a configuration's ``repro_arch``.

The model's own arithmetic, 2 FLOPs a multiply-add, as
``src/repro_torch/launch/roofline.py``'s ``model_flops`` counts it
(2·active parameters a token, the tied output head included), made
exact per layer and frozen here: the MoE counts its router and its
``top_k`` experts (not the whole stack the one-hot dispatch reads);
attention adds 4·D FLOPs per query head and position read (q·k and p·v,
as ``flash_decode_flops``); a Mamba2 layer adds its conv taps and 5
FLOPs per state element (decay, input, the sum, and the read-out's
multiply-add); zamba2's shared block counts at every insertion.
"""

from __future__ import annotations

from perfbench.weights import head_dim, shared_head_dim, ssm_dims


def _layers(a: dict) -> list[dict]:
    return list(a["period"]) * a["n_periods"] + list(a.get("remainder", []))


def token_flops(a: dict, positions_read: int) -> float:
    """FLOPs of one token whose attention reads ``positions_read``
    positions (its own included)."""
    d, F_ = a["d_model"], a["d_ff"]
    total = 2.0 * d * a["vocab"]  # the output head
    for spec in _layers(a):
        if spec.get("shared_attn"):
            d2, H = 2 * d, a["shared_attn_heads"]
            hd = shared_head_dim(a)
            total += 2.0 * d2 * H * hd * 4  # q, k, v, o
            total += 4.0 * positions_read * H * hd
            total += 2.0 * d2 * F_ * 3 + 2.0 * d2 * d
        if spec["mixer"] == "attn":
            H, KV, hd = a["n_heads"], a["n_kv_heads"], head_dim(a)
            total += 2.0 * d * (2 * H * hd + 2 * KV * hd)
            total += 4.0 * positions_read * H * hd
        else:
            d_inner, nh, conv_dim = ssm_dims(a)
            G, N = a["ssm_groups"], a["ssm_state"]
            total += 2.0 * d * (2 * d_inner + 2 * G * N + nh) + 2.0 * d_inner * d
            total += 2.0 * a["ssm_conv"] * conv_dim
            total += 5.0 * nh * a["ssm_head_dim"] * N
        if spec["ffn"] == "mlp":
            total += 2.0 * d * F_ * 3
        elif spec["ffn"] == "moe":
            total += 2.0 * d * a["n_experts"] + a["top_k"] * 2.0 * d * F_ * 3
    return total


def attention_layers(a: dict) -> list[tuple[int, int, int]]:
    """(K/V heads, query heads per K/V head, head dim) of every layer
    whose attention reads a K/V cache through ``flash_decode``."""
    out = []
    for spec in _layers(a):
        if spec.get("shared_attn"):
            out.append((a["shared_attn_heads"], 1, shared_head_dim(a)))
        if spec["mixer"] == "attn":
            out.append((a["n_kv_heads"], a["n_heads"] // a["n_kv_heads"], head_dim(a)))
    return out
