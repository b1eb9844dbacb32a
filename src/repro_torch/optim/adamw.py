"""AdamW with fp32 accumulators and the cosine schedule (port of the
reference's ``optim/adamw.py``).

Plain tensor functions over a params tree (nested dicts and tuples of
tensors); the state is ``{"step", "m", "v"}`` as in the reference.
Accumulators are fp32 whatever the param dtype; the update is computed
in fp32 and cast back. Leaves are visited in the reference's
``tree_leaves`` order (dict keys sorted), so ``global_norm`` sums them in
the same order, and the schedule is computed in fp32 tensors on the
params' device, so ``lr`` is the reference's float32 value.

One departure: ``apply_updates`` writes the new params and moments IN
PLACE into the tensors it is given (and returns the same trees), where
the reference returns new arrays, a few rows of a leaf at a time. At
full width this keeps one copy of the params and the moments on the
card, not two, and the update's fp32 temporaries to a few hundred MB
(mamba2-2.7b's stacked ``in_proj`` alone is 1.7G elements).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree_util import leaves, tree_map


# elements of a leaf updated at once
_CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def init_state(params: Any) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine to 10% of ``cfg.lr``; fp32 on ``step``'s
    device (``step`` an int32 scalar tensor)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any, state: dict,
                  gnorm: torch.Tensor | None = None) -> tuple[Any, dict, dict]:
    """One AdamW step; params, ``state["m"]`` and ``state["v"]`` are
    updated in place and returned with the new step and ``{"grad_norm",
    "lr"}`` (fp32 scalar tensors). A sharded step passes its rank's
    shards and the global ``gnorm`` it summed over the ranks."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    fstep = step.float()
    bc1 = 1 - cfg.b1 ** fstep
    bc2 = 1 - cfg.b2 ** fstep
    for leaf in zip(leaves(params), leaves(grads), leaves(state["m"]),
                    leaves(state["v"])):
        # a stacked leaf (n_periods, ...) is updated a few rows at a time:
        # its fp32 temporaries stay near _CHUNK elements, not ~7 GB each
        rows = max(1, _CHUNK // max(leaf[0][0].numel(), 1)) if leaf[0].dim() else 1
        for p, g, m, v in zip(*(t.split(rows) if t.dim() else (t,) for t in leaf)):
            g = g.float() * scale
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, {"step": step, "m": state["m"], "v": state["v"]}, \
        {"grad_norm": gnorm, "lr": lr}
