"""Shape-level trace and plan of the full-sequence prefill.

Partial twin of the reference's ``launch/compile.py``
(``trace_prefill_graph``, ``compile.py:159-186``): the prefill of ONE
request (batch 1 — the engine fills slots one request at a time) at
``prefill_len`` tokens, traced on fake tensors over a shape-only
(``meta``) parameter template, so nothing is drawn, computed or
allocated. This is the long-activation-lifetime regime in which the
paper's strategies matter most. Plan bundles, sessions, AOT artifacts
and a command line come with ROADMAP A12.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.graph import Graph
from repro_torch.core.planner import MemoryPlan, plan_graph
from repro_torch.models.api import DecoderModel
from repro_torch.trace.fx_liveness import trace_graph


def trace_prefill_graph(cfg: ArchConfig, *, prefill_len: int) -> Graph:
    """The usage-record graph of ``Model.prefill`` on one request of
    ``prefill_len`` tokens. The graph is the one the same call traces
    with real weights: only shapes and dtypes reach the tracer."""
    if prefill_len < 1:
        raise ValueError(f"prefill_len must be >= 1, got {prefill_len}")
    model = DecoderModel(cfg, "meta")
    params = model.init(None)
    tokens = torch.zeros((1, prefill_len), dtype=torch.int64, device="meta")

    def prefill(p, t):
        return model.prefill(p, {"tokens": t})

    return trace_graph(prefill, params, tokens,
                       name=f"{cfg.name}-prefill{prefill_len}")


def plan_prefill(cfg: ArchConfig, *, prefill_len: int) -> tuple[Graph, MemoryPlan]:
    """Trace the prefill and plan its activations with the paper's
    planner (offsets mode and the ``auto`` portfolio, as the reference's
    ``--prefill-len``)."""
    graph = trace_prefill_graph(cfg, prefill_len=prefill_len)
    return graph, plan_graph(graph, mode="offsets", strategy="auto")
