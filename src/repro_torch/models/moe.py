"""Mixture-of-Experts FFN: top-k router + capacity-based one-hot dispatch.

Port of the reference's ``models/moe.py`` (``moe_init``,
``dispatch_group_size``, ``moe_apply``) with every cast point kept: the
router runs in fp32 on ``x.float()``, its softmax in fp32, the top-k
gate values are renormalised among the chosen with a clip of 1e-9, the
dispatch and combine one-hots are built in fp32 and cast to ``x.dtype``
for the expert products.

The dispatch is the reference's GShard/Switch form, kept whole: tokens
are split into groups of ``dispatch_group_size`` (padding at the end,
added after routing, so it takes no capacity); each expert takes at most
``capacity = max(int(cf·g·k/E), 1)`` of a group's (token, choice)
assignments, ranked by an exclusive cumsum over the group's flattened
``(g·k)`` axis (token major); an assignment ranked past the capacity is
dropped, through a one-hot over ``capacity + 1`` classes sliced to
``capacity``. Every shape is static: no sort, no ``nonzero``, no index
list of data-dependent length and no host read, so the step traces on
fake tensors, is planned and certified, and is captured as a CUDA
graph. ``moe_route`` is the ranking and dropping on its own, so callers
can read how many assignments were kept (``Route.kept``).

The reference's four ``einsum`` products are written as explicit
``bmm`` over 3-D reshapes (group-major for dispatch and combine,
expert-major for the experts). At decode the group, its size and the
capacity are all 1; through the reshapes no traced product meets a
size-1 axis whose stride fake tensors set otherwise than eager (the
fault ROADMAP §C records for the attention output). The products are
plain matrix products: the reference leaves them to XLA, outside any
Pallas kernel.

In the one-hot form every expert's weights are read on every call, the
experts no token was routed to included: at decode, where each slot is
a group of one token with capacity 1 and so never drops, the step
reads all ``E`` experts for ``B·k`` assignments.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import activation, init_linear, mlp_apply, mlp_init


def _expert_stack(generator, lead: tuple[int, ...], n_experts: int, d_in: int,
                  d_out: int, dtype, device) -> torch.Tensor:
    """``(*lead, n_experts, d_in, d_out)`` of U(±1/√d_in), each expert's
    matrix drawn on its own into the preallocated stack: the fp32 draw
    of one matrix is the only temporary (a whole llama4 stack drawn in
    fp32 at once would need 2 × 21.5 GB beside the bf16 stacks)."""
    out = torch.empty((*lead, n_experts, d_in, d_out), dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    flat = out.view(-1, d_in, d_out)
    for i in range(flat.shape[0]):
        flat[i] = init_linear(generator, (d_in, d_out), dtype, device)
    return out


def moe_init(generator, lead: tuple[int, ...], d_model: int, d_ff: int,
             n_experts: int, act: str, shared_expert: bool, dtype, device) -> dict:
    """The router ``(*lead, d_model, E)`` in fp32, the expert stacks
    ``w_in``/``w_gate`` ``(*lead, E, d_model, d_ff)`` and ``w_out``
    ``(*lead, E, d_ff, d_model)`` in ``dtype``, and with
    ``shared_expert`` a dense MLP of the same width (``shared``)."""
    p = {
        "router": init_linear(generator, (*lead, d_model, n_experts), torch.float32,
                              device),
        "w_in": _expert_stack(generator, lead, n_experts, d_model, d_ff, dtype, device),
        "w_gate": _expert_stack(generator, lead, n_experts, d_model, d_ff, dtype,
                                device),
        "w_out": _expert_stack(generator, lead, n_experts, d_ff, d_model, dtype, device),
    }
    if shared_expert:
        p["shared"] = mlp_init(generator, lead, d_model, d_ff, act, dtype, device)
    return p


def dispatch_group_size(d_ff: int, top_k: int, seq_len: int,
                        capacity_factor: float = 1.25) -> int:
    """One-hot dispatch costs S·(S·k·cf)·D per group (quadratic in group
    size) while expert compute is S·k·6·D·F — so cap the group size at
    ~0.6·F/cf to keep dispatch ≲10% of expert FLOPs (GShard sizing)."""
    target = max(int(0.6 * d_ff / capacity_factor), 128)
    g = 128
    while g * 2 <= min(target, 4096):
        g *= 2
    return min(g, max(seq_len, 1))


def capacity_of(group: int, top_k: int, n_experts: int,
                capacity_factor: float = 1.25) -> int:
    """Assignments one expert takes from one group."""
    return max(int(capacity_factor * group * top_k / n_experts), 1)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over ``n`` classes (an index outside
    [0, n) gives a zero row), as a comparison with a static arange."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


class Route(NamedTuple):
    """The grouped capacity dispatch of one call, both ``(B, G, g, E, C)``
    fp32: ``dispatch[b, n, s, e, c]`` is 1 where token s of group n took
    slot c of expert e; ``combine`` is the same weighted by the token's
    renormalised gate value for e."""

    dispatch: torch.Tensor
    combine: torch.Tensor

    @property
    def kept(self) -> torch.Tensor:
        """(token, expert) assignments that found a slot: each is one 1
        of ``dispatch``, and every other assignment was dropped."""
        return self.dispatch.sum()


def moe_route(sel: torch.Tensor, gate: torch.Tensor, *, group: int,
              capacity: int) -> Route:
    """Rank and drop: ``sel`` ``(B, S, k, E)`` fp32 one-hot of each
    token's chosen experts, ``gate`` ``(B, S, k)`` their renormalised
    weights. The sequence is padded at its end to whole groups of
    ``group`` tokens (a padded token chooses nothing); each (token,
    choice) gets its rank among the group's earlier assignments to the
    same expert (an exclusive cumsum over the flattened ``(g·k)`` axis,
    token major), and a rank at or past ``capacity`` is dropped."""
    B, S, k, E = sel.shape
    pad = (-S) % group
    if pad:
        sel = F.pad(sel, (0, 0, 0, 0, 0, pad))
        gate = F.pad(gate, (0, 0, 0, pad))
    G = (S + pad) // group
    sel_g = sel.reshape(B, G, group, k, E)
    flat = sel_g.reshape(B, G, group * k, E)
    pos = (torch.cumsum(flat, dim=2) - flat).reshape(B, G, group, k, E)
    within = pos < capacity
    idx = torch.where(within, pos, float(capacity)).to(torch.int64)
    cap_oh = _one_hot(idx, capacity + 1)[..., :capacity]  # (B,G,g,k,E,C)
    dispatch = (sel_g[..., None] * cap_oh).sum(3)  # (B,G,g,E,C)
    combine = ((sel_g * gate.reshape(B, G, group, k)[..., None])[..., None]
               * cap_oh).sum(3)
    return Route(dispatch, combine)


def moe_apply(
    p: dict,
    x: torch.Tensor,  # (B, S, D)
    *,
    n_experts: int,
    top_k: int,
    act: str,
    capacity_factor: float = 1.25,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, S, D) in x's dtype, the Switch aux loss, a fp32
    scalar), as the reference's ``moe_apply``."""
    B, S, D = x.shape
    E = n_experts
    f = activation(act)
    logits = (x.float().reshape(B * S, D) @ p["router"]).reshape(B, S, E)
    probs = torch.softmax(logits, dim=-1)

    # top-k gating, renormalised among the chosen
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)  # (B,S,k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Switch aux loss: E * sum_e (fraction_tokens_e * mean_prob_e)
    sel = _one_hot(gate_idx, E)  # (B,S,k,E)
    tokens_per_expert = sel.sum((1, 2)) / (S * top_k)  # (B,E)
    mean_prob = probs.mean(1)  # (B,E)
    aux = (tokens_per_expert * mean_prob).sum(-1).mean() * E

    # ---- grouped capacity dispatch
    d_ff = p["w_in"].shape[-1]
    g = dispatch_group_size(d_ff, top_k, S, capacity_factor)
    C = capacity_of(g, top_k, E, capacity_factor)
    route = moe_route(sel, gate_vals, group=g, capacity=C)
    G = route.dispatch.shape[1]
    BG, Sp = B * G, G * g
    x_p = F.pad(x, (0, 0, 0, Sp - S)) if Sp > S else x

    # "bnsec,bnsd->bnecd": each group's expert inputs
    disp = route.dispatch.to(x.dtype).reshape(BG, g, E * C)
    xin = torch.bmm(disp.transpose(1, 2), x_p.reshape(BG, g, D))  # (BG, E·C, D)
    # "bnecd,edf->bnecf" (twice) and "bnecf,efd->bnecd", expert-major
    xe = xin.reshape(BG, E, C, D).transpose(0, 1).reshape(E, BG * C, D)
    h = torch.bmm(xe, p["w_in"])
    gt = torch.bmm(xe, p["w_gate"])
    h = f(gt) * h
    eo = torch.bmm(h, p["w_out"])  # (E, BG·C, D)
    eo = eo.reshape(E, BG, C, D).transpose(0, 1).reshape(BG, E * C, D)
    # "bnsec,bnecd->bnsd": back to the tokens, weighted by their gates
    comb = route.combine.to(x.dtype).reshape(BG, g, E * C)
    out = torch.bmm(comb, eo).reshape(B, Sp, D)[:, :S]

    if "shared" in p:
        out = out + mlp_apply(p["shared"], x, act)
    return out, aux

