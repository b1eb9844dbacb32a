"""Activation-half planner: strategies, MemoryPlan, and thin wrappers.

``plan_records``/``plan_graph`` are wrappers over the unified facade
(:func:`repro_torch.core.plan` in :mod:`repro_torch.core.unified`), which also covers
the cross-step state half; the strategy dispatch itself lives here in
``_plan_records_impl``.

Implements the paper's §6 deployment recommendations:
* Shared Objects engines: default to Greedy-by-Size-Improved.
* Offset Calculation engines: evaluate Greedy-by-Size AND Strip-Packing
  Best-fit before first inference, pick the smaller (§6 last paragraph).
``strategy="auto"`` runs every known strategy and returns the best.

Every ``plan_records``/``plan_graph`` call consults the content-addressed
plan cache (:mod:`repro_torch.core.plan_io`): the signature covers the record
set, mode and strategy, so repeat engine construction and auto-strategy
sweeps over an unchanged graph return the stored plan (``cache_hit=True``)
without re-running any strategy. Pass ``use_cache=False`` to force a
fresh run, or ``cache=`` to use a private :class:`~repro_torch.core.plan_io.PlanCache`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Literal, Sequence

from repro_torch.core import baselines, offsets, plan_io, shared_objects
from repro_torch.core.graph import Graph
from repro_torch.core.offsets import OffsetAssignment, from_shared_objects
from repro_torch.core.records import (
    DEFAULT_ALIGNMENT,
    TensorUsageRecord,
    naive_consumption,
    offsets_lower_bound,
    shared_objects_lower_bound,
)
from repro_torch.core.shared_objects import SharedObjectsAssignment

Mode = Literal["shared_objects", "offsets"]

# Instrumentation: total plan_records entries this process (cache hits
# included — a bundle-served engine must not even consult the planner).
# Tests snapshot it around engine construction.
PLAN_CALLS = 0

SHARED_OBJECT_STRATEGIES: dict[
    str, Callable[[Sequence[TensorUsageRecord]], SharedObjectsAssignment]
] = {
    **shared_objects.STRATEGIES,
    "tflite_greedy_in_order": baselines.tflite_greedy_in_order,
    "min_cost_flow": baselines.min_cost_flow_assignment,
    "naive": baselines.naive_shared_objects,
}


def _register_extensions() -> None:
    # late import: extensions depend on the base strategies above
    from repro_torch.core import extensions

    SHARED_OBJECT_STRATEGIES["greedy_by_conflict"] = extensions.greedy_by_conflict
    OFFSET_STRATEGIES["best_of_all"] = extensions.offsets_best_of_all

OFFSET_STRATEGIES: dict[
    str, Callable[[Sequence[TensorUsageRecord]], OffsetAssignment]
] = {
    **offsets.STRATEGIES,
    "tflite_greedy_in_order": baselines.tflite_greedy_in_order_offsets,
    "strip_packing_bestfit": baselines.strip_packing_bestfit,
    "naive": baselines.naive_offsets,
}

_register_extensions()

# The strategy portfolios "auto" evaluates, by mode. Named here (not
# inline) because the cache key spells them out: adding a strategy to a
# portfolio must invalidate previously cached auto plans.
AUTO_SHARED_OBJECT_PORTFOLIO: tuple[str, ...] = tuple(shared_objects.STRATEGIES)
AUTO_OFFSET_PORTFOLIO: tuple[str, ...] = (
    "greedy_by_size",
    "greedy_by_breadth",
    "strip_packing_bestfit",
)


def _cache_strategy_key(mode: Mode, strategy: str) -> str:
    if strategy != "auto":
        return strategy
    portfolio = (
        AUTO_SHARED_OBJECT_PORTFOLIO
        if mode == "shared_objects"
        else AUTO_OFFSET_PORTFOLIO
    )
    return "auto[" + ",".join(sorted(portfolio)) + "]"


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
    shared_objects: SharedObjectsAssignment | None = None
    # True when this plan came out of the plan cache instead of a strategy
    # run (not serialized; see plan_io).
    cache_hit: bool = False

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
    mode: Mode = "offsets",
    strategy: str = "auto",
    graph_name: str = "records",
    cache: plan_io.PlanCache | None = None,
    use_cache: bool = True,
) -> MemoryPlan:
    """Thin wrapper over the unified facade (:func:`repro_torch.core.plan`):
    plans the activation half only. The strategy implementations live in
    :func:`_plan_records_impl`, which ``unified.plan`` dispatches to."""
    from repro_torch.core import unified  # function-level: unified imports planner

    spec = unified.PlanSpec(
        records=list(records), mode=mode, strategy=strategy,
        graph_name=graph_name, cache=cache, use_cache=use_cache,
    )
    return unified.plan(spec).activation


def _plan_records_impl(
    records: Sequence[TensorUsageRecord],
    *,
    mode: Mode = "offsets",
    strategy: str = "auto",
    graph_name: str = "records",
    cache: plan_io.PlanCache | None = None,
    use_cache: bool = True,
) -> MemoryPlan:
    global PLAN_CALLS
    PLAN_CALLS += 1
    records = list(records)
    t0 = time.perf_counter()
    key: str | None = None
    if use_cache:
        cache = cache if cache is not None else plan_io.default_cache()
        key = plan_io.plan_signature(
            records, mode=mode, strategy=_cache_strategy_key(mode, strategy)
        )
        hit = cache.get(key)
        if hit is not None:
            return dataclasses.replace(
                hit,
                graph_name=graph_name,
                plan_wall_s=time.perf_counter() - t0,
                cache_hit=True,
            )
    so: SharedObjectsAssignment | None = None
    if mode == "shared_objects":
        lb = shared_objects_lower_bound(records)
        if strategy == "auto":
            # paper: GBS-Improved is the recommended default, but evaluate all
            cands = [
                shared_objects.STRATEGIES[name](records)
                for name in AUTO_SHARED_OBJECT_PORTFOLIO
            ]
            so = min(cands, key=lambda a: a.total_size)
        else:
            so = SHARED_OBJECT_STRATEGIES[strategy](records)
        off = from_shared_objects(so)
        name = so.strategy
    else:
        lb = offsets_lower_bound(records)
        if strategy == "auto":
            # paper §6: evaluate GBS and Strip-Packing Best-fit, pick best;
            # we also throw in GBB for completeness.
            cands = [
                OFFSET_STRATEGIES[name](records)
                for name in AUTO_OFFSET_PORTFOLIO
            ]
            off = min(cands, key=lambda a: a.total_size)
        else:
            off = OFFSET_STRATEGIES[strategy](records)
        name = off.strategy
    wall = time.perf_counter() - t0
    plan = MemoryPlan(
        graph_name=graph_name,
        strategy=name,
        records=records,
        offsets=dict(off.offsets),
        total_size=off.total_size,
        lower_bound=lb,
        naive_size=naive_consumption(records),
        plan_wall_s=wall,
        shared_objects=so,
    )
    if key is not None and cache is not None:
        cache.put(key, plan)
    return plan


def plan_graph(
    graph: Graph,
    *,
    mode: Mode = "offsets",
    strategy: str = "auto",
    alignment: int = DEFAULT_ALIGNMENT,
    cache: plan_io.PlanCache | None = None,
    use_cache: bool = True,
) -> MemoryPlan:
    """Thin wrapper over the unified facade. Alignment needs no explicit
    cache key: it is baked into the record sizes the signature hashes."""
    from repro_torch.core import unified  # function-level: unified imports planner

    spec = unified.PlanSpec(
        graph=graph, mode=mode, strategy=strategy, alignment=alignment,
        cache=cache, use_cache=use_cache,
    )
    return unified.plan(spec).activation
