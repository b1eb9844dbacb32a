"""The weights of a cell, made on the device from ``--seed``.

The benchmark makes the weights itself, in the layout the port's decode
step takes (``params["period"][j]`` stacked over the periods,
``params["remainder"]``, zamba2's ``params["shared_attn"]``; matrices
``(d_in, d_out)``), one draw per stacked leaf, straight in the dtype each
leaf is served in. Both the program and the plain reference
(``reference.py``) read these tensors; neither makes its own.

Distributions: linear maps U(±1/√d_in); the embedding (tied to the
output head) N(0, 1/d_model); RMSNorm scales U(±0.2) (the models
multiply by 1 + scale); the router U(±1/√d_model) in fp32; Mamba2's
A = U(1, 16) (``A_log`` its log), ``dt_bias`` the inverse softplus of
a log-uniform dt in [0.001, 0.1], D = U(0.5, 1.5), the conv taps
N(0, 0.1²) and its bias U(±0.1).
"""

from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def ssm_dims(a: dict) -> tuple[int, int, int]:
    """(d_inner, heads, conv channels) of a Mamba2 layer."""
    d_inner = a["ssm_expand"] * a["d_model"]
    heads = d_inner // a["ssm_head_dim"]
    return d_inner, heads, d_inner + 2 * a["ssm_groups"] * a["ssm_state"]


def head_dim(a: dict) -> int:
    return a.get("head_dim") or a["d_model"] // a["n_heads"]


def shared_head_dim(a: dict) -> int:
    return 2 * a["d_model"] // a["shared_attn_heads"]


def _layer(a: dict, spec: dict, lead: tuple, dt) -> dict:
    """(shape, dtype, kind) of each leaf of one layer."""
    d = a["d_model"]
    f32 = torch.float32
    p = {"ln1": ((*lead, d), f32, "norm"), "ln2": ((*lead, d), f32, "norm")}
    if spec["mixer"] == "attn":
        H, KV, hd = a["n_heads"], a["n_kv_heads"], head_dim(a)
        p["attn"] = {"wq": ((*lead, d, H * hd), dt, "linear"),
                     "wk": ((*lead, d, KV * hd), dt, "linear"),
                     "wv": ((*lead, d, KV * hd), dt, "linear"),
                     "wo": ((*lead, H * hd, d), dt, "linear")}
        if a.get("qk_norm"):
            p["attn"]["q_norm"] = ((*lead, hd), f32, "norm")
            p["attn"]["k_norm"] = ((*lead, hd), f32, "norm")
    else:
        d_inner, H, conv_dim = ssm_dims(a)
        G, N, K = a["ssm_groups"], a["ssm_state"], a["ssm_conv"]
        p["mamba"] = {
            "in_proj": ((*lead, d, 2 * d_inner + 2 * G * N + H), dt, "linear"),
            "conv_w": ((*lead, K, conv_dim), dt, "conv_w"),
            "conv_b": ((*lead, conv_dim), dt, "conv_b"),
            "A_log": ((*lead, H), f32, "A_log"),
            "D": ((*lead, H), f32, "D"),
            "dt_bias": ((*lead, H), f32, "dt_bias"),
            "norm": ((*lead, d_inner), f32, "norm"),
            "out_proj": ((*lead, d_inner, d), dt, "linear"),
        }
    F_ = a["d_ff"]
    if spec["ffn"] == "mlp":
        p["mlp"] = {"w_in": ((*lead, d, F_), dt, "linear"),
                    "w_gate": ((*lead, d, F_), dt, "linear"),
                    "w_out": ((*lead, F_, d), dt, "linear")}
    elif spec["ffn"] == "moe":
        E = a["n_experts"]
        p["moe"] = {"router": ((*lead, d, E), f32, "linear"),
                    "w_in": ((*lead, E, d, F_), dt, "linear"),
                    "w_gate": ((*lead, E, d, F_), dt, "linear"),
                    "w_out": ((*lead, E, F_, d), dt, "linear")}
    return p


def layout(a: dict) -> dict:
    """The weights of the architecture ``a`` (a configuration file's
    ``repro_arch``) as a tree of (shape, dtype, kind)."""
    dt = DTYPES[a["dtype"]]
    d, f32 = a["d_model"], torch.float32
    tree = {
        "embed": ((a["vocab"], d), dt, "embed"),
        "ln_f": ((d,), f32, "norm"),
        "period": tuple(_layer(a, s, (a["n_periods"],), dt) for s in a["period"]),
        "remainder": tuple(_layer(a, s, (), dt) for s in a.get("remainder", [])),
    }
    if any(s.get("shared_attn") for s in (*a["period"], *a.get("remainder", []))):
        d2, H, hd = 2 * d, a["shared_attn_heads"], shared_head_dim(a)
        tree["shared_attn"] = {
            "ln": ((d2,), f32, "norm"),
            "attn": {"wq": ((d2, H * hd), dt, "linear"),
                     "wk": ((d2, H * hd), dt, "linear"),
                     "wv": ((d2, H * hd), dt, "linear"),
                     "wo": ((H * hd, d2), dt, "linear")},
            "mlp": {"w_in": ((d2, a["d_ff"]), dt, "linear"),
                    "w_gate": ((d2, a["d_ff"]), dt, "linear"),
                    "w_out": ((a["d_ff"], d2), dt, "linear")},
            "ln2": ((d2,), f32, "norm"),
            "out": ((d2, d), dt, "linear"),
        }
    return tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and not (len(tree) == 3 and isinstance(tree[2], str)):
        return tuple(_map(v, fn) for v in tree)
    return fn(tree)


def _pairs(params, lay):
    if isinstance(lay, dict):
        for k in lay:
            yield from _pairs(params[k], lay[k])
    elif isinstance(lay, tuple) and not (len(lay) == 3 and isinstance(lay[2], str)):
        for p, l_ in zip(params, lay):
            yield from _pairs(p, l_)
    else:
        yield params, lay


def allocate(a: dict, device) -> dict:
    return _map(layout(a), lambda s: torch.empty(s[0], dtype=s[1], device=device))


def fill(params: dict, a: dict, seed: int) -> dict:
    """Draw every leaf of ``params`` (laid out by ``layout(a)``) in place
    from ``seed``: the same seed gives the same weights."""
    device = next(t for t, _ in _pairs(params, layout(a))).device
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    with torch.no_grad():
        for t, (shape, _, kind) in _pairs(params, layout(a)):
            if kind == "linear":
                s = 1.0 / math.sqrt(shape[-2])
                t.uniform_(-s, s, generator=g)
            elif kind == "embed":
                t.normal_(0.0, 1.0 / math.sqrt(shape[-1]), generator=g)
            elif kind == "norm":
                t.uniform_(-0.2, 0.2, generator=g)
            elif kind == "conv_w":
                t.normal_(0.0, 0.1, generator=g)
            elif kind == "conv_b":
                t.uniform_(-0.1, 0.1, generator=g)
            elif kind == "A_log":
                t.uniform_(1.0, 16.0, generator=g).log_()
            elif kind == "D":
                t.uniform_(0.5, 1.5, generator=g)
            elif kind == "dt_bias":
                dt = t.uniform_(math.log(1e-3), math.log(1e-1), generator=g).exp_()
                t.copy_(dt + torch.log(-torch.expm1(-dt)))
            else:
                raise ValueError(f"unknown leaf kind {kind!r}")
    return params


def make(a: dict, seed: int, device) -> dict:
    return fill(allocate(a, device), a, seed)


def nbytes(params) -> int:
    if isinstance(params, dict):
        return sum(nbytes(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(nbytes(v) for v in params)
    return params.numel() * params.element_size()
