"""Quickstart: plan ANY PyTorch function's intermediate-tensor memory.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Twin of the reference's ``examples/quickstart.py``: MobileNet v1 planned
by the paper's Greedy by Size for Offset Calculation, then a small
function traced (``trace/fx_liveness``), planned and run out of one flat
arena by :class:`~repro_torch.runtime.executor.ArenaExecutor` on
``--device`` (default: the card; without one it raises), its output held
against eager.

The arena equals the reference's (0.125 MiB), but the naive total is
smaller (0.251 against 0.254 MiB): aten's ``_softmax`` is one node of
the traced graph, where the reference's jaxpr decomposes softmax into
several intermediates.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.planner import plan_graph
from repro_torch.models.convnets import mobilenet_v1
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.executor import ArenaExecutor
from repro_torch.trace.fx_liveness import trace_graph

# the reference's shapes: x, w1, w2, w3
SHAPES = ((32, 256), (256, 512), (512, 512), (512, 10))


def make_input(rng: np.random.Generator, shape: tuple[int, int]) -> np.ndarray:
    """Standard normal over the square root of the first dim, so each
    product keeps unit scale and the softmax is not one-hot."""
    return (rng.standard_normal(shape) / np.sqrt(shape[0])).astype(np.float32)


def my_model(x, w1, w2, w3):
    h = torch.relu(x @ w1)
    h = torch.relu(h @ w2)
    return torch.softmax(h @ w3, dim=-1)


def main(argv: list[str] | None = None) -> dict:
    """Run the three steps and return what they printed, as numbers:
    MobileNet's plan, ``my_model``'s plan, the executor's stats and its
    output's largest difference from eager."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device of the arena (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random arguments")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. The paper's planner on MobileNet v1 (paper Table 2 row 1)
    mobilenet = plan_graph(mobilenet_v1(), mode="offsets", strategy="greedy_by_size")
    print("MobileNet v1:", mobilenet.summary())

    # 2. Any PyTorch function: trace -> usage records -> plan
    rng = np.random.default_rng(args.seed)
    inputs = tuple(torch.from_numpy(make_input(rng, s)).to(device) for s in SHAPES)
    plan = plan_graph(trace_graph(my_model, *inputs))
    print("my_model:", plan.summary())

    # 3. Execute with real buffer reuse: one flat arena, planned offsets
    ex = ArenaExecutor(my_model, *inputs, device=device)
    out = ex(*inputs)
    ref = my_model(*inputs)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=0)
    print(f"arena executor: {ex.stats.arena_bytes / 2**20:.3f} MiB arena vs "
          f"{ex.stats.naive_peak_bytes / 2**20:.3f} MiB naive "
          f"({ex.stats.reduction:.2f}x smaller), outputs match eager")
    return {
        "device": str(device),
        "mobilenet_total_bytes": mobilenet.total_size,
        "mobilenet_naive_bytes": mobilenet.naive_size,
        "plan_total_bytes": plan.total_size,
        "plan_naive_bytes": plan.naive_size,
        "arena_bytes": ex.stats.arena_bytes,
        "naive_peak_bytes": ex.stats.naive_peak_bytes,
        "reduction": ex.stats.reduction,
        "max_abs_err": float((out - ref).abs().max()),
        "output": out,
    }


if __name__ == "__main__":
    main()
