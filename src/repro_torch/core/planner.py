"""Activation planner in offsets mode (copy of the reference's
``core/planner.py`` for the Offset Calculation half).

Implements the paper's §6 recommendation for Offset Calculation engines:
evaluate Greedy-by-Size AND Strip-Packing Best-fit before first
inference, pick the smaller; ``strategy="auto"`` runs the reference's
portfolio (those two plus Greedy-by-Breadth) and returns the best.

The reference's content-addressed plan cache (``plan_io``) and its
Shared Objects mode are not part of this slice: every call plans afresh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

from repro_torch.core.graph import Graph
from repro_torch.core.offsets import STRATEGIES as OFFSET_STRATEGIES
from repro_torch.core.records import (
    DEFAULT_ALIGNMENT,
    TensorUsageRecord,
    naive_consumption,
    offsets_lower_bound,
)

# Instrumentation: total plan_records calls this process. Tests snapshot
# it around engine construction.
PLAN_CALLS = 0

# The strategy portfolio "auto" evaluates (reference: planner.py:79-83).
AUTO_OFFSET_PORTFOLIO: tuple[str, ...] = (
    "greedy_by_size",
    "greedy_by_breadth",
    "strip_packing_bestfit",
)


@dataclasses.dataclass
class MemoryPlan:
    """An offset plan ready for arena materialization."""

    graph_name: str
    strategy: str
    records: list[TensorUsageRecord]
    offsets: dict[int, int]  # tensor_id -> byte offset
    total_size: int
    lower_bound: int
    naive_size: int
    plan_wall_s: float

    @property
    def reduction_vs_naive(self) -> float:
        return self.naive_size / max(self.total_size, 1)

    @property
    def fraction_of_lower_bound(self) -> float:
        return self.total_size / max(self.lower_bound, 1)

    def summary(self) -> str:
        return (
            f"{self.graph_name}[{self.strategy}]: {self.total_size / 2**20:.3f} MiB "
            f"(naive {self.naive_size / 2**20:.3f}, LB {self.lower_bound / 2**20:.3f}, "
            f"{self.reduction_vs_naive:.2f}x smaller than naive, "
            f"{self.fraction_of_lower_bound:.3f}x LB)"
        )


def plan_records(
    records: Sequence[TensorUsageRecord],
    *,
    mode: str = "offsets",
    strategy: str = "auto",
    graph_name: str = "records",
) -> MemoryPlan:
    """Plan usage records into one arena (Offset Calculation, paper §5)."""
    global PLAN_CALLS
    if mode != "offsets":
        raise NotImplementedError(
            f"mode {mode!r}: the port plans in offsets mode only; Shared "
            f"Objects mode comes with the plan-cache slice (ROADMAP A12)"
        )
    PLAN_CALLS += 1
    records = list(records)
    t0 = time.perf_counter()
    if strategy == "auto":
        cands = [OFFSET_STRATEGIES[name](records) for name in AUTO_OFFSET_PORTFOLIO]
        off = min(cands, key=lambda a: a.total_size)
    else:
        off = OFFSET_STRATEGIES[strategy](records)
    return MemoryPlan(
        graph_name=graph_name,
        strategy=off.strategy,
        records=records,
        offsets=dict(off.offsets),
        total_size=off.total_size,
        lower_bound=offsets_lower_bound(records),
        naive_size=naive_consumption(records),
        plan_wall_s=time.perf_counter() - t0,
    )


def plan_graph(
    graph: Graph,
    *,
    mode: str = "offsets",
    strategy: str = "auto",
    alignment: int = DEFAULT_ALIGNMENT,
) -> MemoryPlan:
    return plan_records(
        graph.usage_records(alignment), mode=mode, strategy=strategy,
        graph_name=graph.name,
    )
