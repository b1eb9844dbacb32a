"""Shape-level trace and plan of the full-sequence prefill.

Partial twin of the reference's ``launch/compile.py``
(``trace_prefill_graph``, ``compile.py:159-186``): the prefill of ONE
request (batch 1 — the engine fills slots one request at a time) at
``prefill_len`` tokens, traced on fake tensors over a shape-only
(``meta``) parameter template, so nothing is drawn, computed or
allocated. Every ported family prefills: attention (global and
sliding-window, qwen3 and gemma3), attention + MoE (granite-moe and
llama4's reduced config: the grouped capacity dispatch's one-hots are
planned with the rest), Mamba2, zamba2's hybrid (Mamba2 layers and the
shared attention block) and internvl2's VLM prefix, a fake
``(1, n_prefix_tokens, d_model)`` input in front of the tokens. The
RoPE tables are inputs of the traced function, as in the decode step's
trace. This is the long-activation-lifetime regime in which the
paper's strategies matter most. Every prefill plan it returns has been
certified by ``analysis/soundness.certify_plan`` (a plan with findings
raises ``LintGateError``). Plan bundles, sessions, AOT artifacts and a
command line come with ROADMAP A12.
"""

from __future__ import annotations

import torch

from repro_torch.analysis import soundness
from repro_torch.analysis.findings import LintGateError, Report
from repro_torch.configs.base import ArchConfig
from repro_torch.core.graph import Graph
from repro_torch.core.planner import MemoryPlan, plan_graph
from repro_torch.models.api import DecoderModel
from repro_torch.trace.fx_liveness import trace_graph


def prefill_batch(cfg: ArchConfig, prefill_len: int, device) -> dict:
    """The batch of one request of ``prefill_len`` positions, zeros on
    ``device``: with a VLM prefix, ``n_prefix_tokens`` embeddings and the
    rest as tokens (at least one), as the reference's ``input_specs``
    counts them (``api.py:97-98``)."""
    P = cfg.n_prefix_tokens
    batch = {"tokens": torch.zeros((1, max(prefill_len - P, 1)), dtype=torch.int64,
                                   device=device)}
    if P:
        batch["prefix_embeds"] = torch.zeros((1, P, cfg.d_model),
                                             dtype=getattr(torch, cfg.dtype),
                                             device=device)
    return batch


def trace_prefill_graph(cfg: ArchConfig, *, prefill_len: int) -> Graph:
    """The usage-record graph of ``Model.prefill`` on one request of
    ``prefill_len`` positions (``prefill_batch``). The graph is the one
    the same call traces with real weights: only shapes and dtypes reach
    the tracer."""
    if prefill_len < 1:
        raise ValueError(f"prefill_len must be >= 1, got {prefill_len}")
    model = DecoderModel(cfg, "meta")
    params = model.init(None)

    def prefill(p, tables, batch):
        return model.prefill(p, batch, **tables)

    return trace_graph(prefill, params, model.rope_tables,
                       prefill_batch(cfg, prefill_len, "meta"),
                       name=f"{cfg.name}-prefill{prefill_len}")


def plan_prefill(cfg: ArchConfig, *, prefill_len: int) -> tuple[Graph, MemoryPlan]:
    """Trace the prefill, plan its activations with the paper's planner
    (offsets mode and the ``auto`` portfolio, as the reference's
    ``--prefill-len``) and certify the plan; findings raise."""
    graph = trace_prefill_graph(cfg, prefill_len=prefill_len)
    plan = plan_graph(graph, mode="offsets", strategy="auto")
    report = Report().extend(soundness.certify_plan(plan), checked=graph.name)
    if not report.ok():
        raise LintGateError(report, context="the prefill plan is not sound")
    return graph, plan
