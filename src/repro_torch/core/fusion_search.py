"""MAFAT-style fusion search over graph partitions (Farley & Gerstlauer '21).

Operator fusion changes the *record set* the planner sees: when a
contiguous run of ops is fused into one kernel, tensors produced and fully
consumed inside the run are never materialized in the arena — they stream
through kernel-local scratch (shared memory/registers). That can break the one
barrier order search cannot move: the peak operator breadth pinned by a
single producer→consumer pair of large tensors.

The model here is deliberately conservative:

* only contiguous runs of the execution order fuse (a fused kernel is one
  op in the schedule);
* a tensor is internalized only if it is not a boundary tensor and EVERY
  consumer lies inside the run — anything observable outside the fused
  kernel is still planned;
* the internalized bytes of a group must fit ``local_budget`` (the MAFAT
  local-memory constraint; the default comes from the Hopper shared-memory
  model in ``kernels/smem_plan`` — one block's opt-in shared memory minus
  the reserve the planned kernel steps keep resident), and a group fuses
  at most ``max_group_ops`` ops;
* a candidate partition is kept ONLY if re-planning the fused graph (via
  the content-addressed plan cache) strictly shrinks the arena, so the
  result is never worse than the unfused baseline.

The search is a deterministic steepest-descent hill-climb over adjacent
group merges — every candidate costs one (cached) ``plan_records`` call,
which is the access pattern the plan cache was built for.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Sequence

from repro_torch.core import plan_io
from repro_torch.core.graph import Graph, Op
from repro_torch.core.records import DEFAULT_ALIGNMENT, align
from repro_torch.kernels.smem_plan import fusion_scratch_budget

if TYPE_CHECKING:
    from repro_torch.core.planner import MemoryPlan


def default_local_budget() -> int:
    """Kernel-local scratch budget for fusion legality: the Hopper
    shared-memory model of ``kernels/smem_plan`` (one block's opt-in
    shared memory minus the reserve the planned kernel steps keep
    resident)."""
    return fusion_scratch_budget()


# import-time snapshot for callers that want a number to display; the
# authoritative value is default_local_budget(), which fusion_search
# resolves at CALL time
DEFAULT_LOCAL_BUDGET = default_local_budget()


def _consumers(graph: Graph) -> dict[int, set[int]]:
    """tensor id -> op indices reading it."""
    cons: dict[int, set[int]] = {}
    for idx, op in enumerate(graph.ops):
        for t in op.inputs:
            cons.setdefault(t, set()).add(idx)
    return cons


def _internal_ids(
    graph: Graph, group: Sequence[int], consumers: dict[int, set[int]]
) -> list[int]:
    """Tensors produced in ``group`` whose every consumer is also in the
    group (and that have at least one consumer, and are not boundary) —
    these stream through kernel-local scratch when the group fuses."""
    members = set(group)
    out = []
    for i in group:
        for t in graph.ops[i].outputs:
            if t in graph.boundary_ids:
                continue
            cons = consumers.get(t, set())
            if cons and cons <= members:
                out.append(t)
    return out


def internal_bytes(
    graph: Graph,
    group: Sequence[int],
    consumers: dict[int, set[int]] | None = None,
    alignment: int = DEFAULT_ALIGNMENT,
) -> int:
    """Aligned bytes of scratch the fused ``group`` keeps on-chip."""
    consumers = consumers if consumers is not None else _consumers(graph)
    return sum(
        align(graph.tensors[t].nbytes, alignment)
        for t in _internal_ids(graph, group, consumers)
    )


def fuse_groups(graph: Graph, groups: Sequence[Sequence[int]]) -> Graph:
    """Build the fused graph for a partition of ``range(len(graph.ops))``
    into contiguous runs (each run becomes one op).

    Internalized tensors vanish from the op list entirely — they get no
    usage record, modelling streaming through kernel-local scratch. The
    tensor table and boundary set are untouched, so everything observable
    outside a fused kernel keeps its spec and its record.
    """
    flat = [i for g in groups for i in g]
    if flat != list(range(len(graph.ops))):
        raise ValueError(
            "groups must partition op indices into contiguous in-order runs"
        )
    consumers = _consumers(graph)
    ops: list[Op] = []
    for group in groups:
        if len(group) == 1:
            ops.append(graph.ops[group[0]])
            continue
        members = set(group)
        internal = set(_internal_ids(graph, group, consumers))
        produced = {t for i in group for t in graph.ops[i].outputs}
        inputs: list[int] = []
        outputs: list[int] = []
        for i in group:
            op = graph.ops[i]
            for t in op.inputs:
                if t not in produced and t not in inputs:
                    inputs.append(t)
            for t in op.outputs:
                if t not in internal:
                    outputs.append(t)
        ops.append(
            Op(
                name="fused(" + "+".join(graph.ops[i].name for i in group) + ")",
                inputs=tuple(inputs),
                outputs=tuple(outputs),
            )
        )
    return Graph(
        name=graph.name,
        ops=ops,
        tensors=graph.tensors,
        boundary_ids=graph.boundary_ids,
    )


@dataclasses.dataclass
class FusionSearchResult:
    """Outcome of :func:`fusion_search`: the fused graph, its plan, the
    unfused baseline plan, the partition, and search statistics."""

    graph: Graph
    plan: "MemoryPlan"
    baseline_plan: "MemoryPlan"
    groups: tuple[tuple[int, ...], ...]
    internalized_bytes: int
    evaluations: int
    cache_hits: int
    cache_misses: int
    wall_s: float

    @property
    def delta_bytes(self) -> int:
        return self.baseline_plan.total_size - self.plan.total_size

    @property
    def n_fused_groups(self) -> int:
        return sum(1 for g in self.groups if len(g) > 1)

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def provenance(self) -> dict:
        """Deterministic compile-time metadata for plan artifacts
        (:mod:`repro_torch.core.unified` merges this into bundle provenance)."""
        return {
            "fused_total_bytes": self.plan.total_size,
            "fused_groups": self.n_fused_groups,
            "internalized_bytes": self.internalized_bytes,
            "fusion_evaluations": self.evaluations,
            "fusion_cache_hits": self.cache_hits,
        }


def fusion_search(
    graph: Graph,
    *,
    mode: str = "offsets",
    strategy: str = "auto",
    max_group_ops: int = 4,
    local_budget: int | None = None,
    cache: "plan_io.PlanCache | None" = None,
    max_rounds: int | None = None,
    alignment: int = DEFAULT_ALIGNMENT,
) -> FusionSearchResult:
    """Steepest-descent search over adjacent group merges.

    Starts from the all-singletons partition; each round evaluates every
    dataflow-adjacent merge that respects ``max_group_ops`` and
    ``local_budget``, re-plans the fused graph through the plan cache, and
    commits the single merge with the smallest planned arena — but only if
    it strictly shrinks it. Terminates when no merge improves (or after
    ``max_rounds``). Deterministic; result is never worse than baseline.
    """
    from repro_torch.core.planner import plan_records

    wall0 = time.perf_counter()
    if local_budget is None:
        local_budget = default_local_budget()
    graph.validate()  # once; fused candidates are valid by construction
    cache = cache if cache is not None else plan_io.PlanCache()
    hits0, misses0 = cache.hits, cache.misses
    evaluations = 0

    consumers = _consumers(graph)
    n = len(graph.ops)
    groups: list[tuple[int, ...]] = [(i,) for i in range(n)]

    baseline_plan = plan_records(
        graph.usage_records(alignment),
        mode=mode,
        strategy=strategy,
        graph_name=graph.name,
        cache=cache,
    )
    evaluations += 1
    best_total = baseline_plan.total_size

    def dataflow_adjacent(a: tuple[int, ...], b: tuple[int, ...]) -> bool:
        produced = {t for i in a for t in graph.ops[i].outputs}
        return any(t in produced for i in b for t in graph.ops[i].inputs)

    rounds = 0
    limit = max_rounds if max_rounds is not None else n
    while rounds < limit:
        rounds += 1
        best_merge: int | None = None
        best_merge_total = best_total
        for gi in range(len(groups) - 1):
            a, b = groups[gi], groups[gi + 1]
            if len(a) + len(b) > max_group_ops:
                continue
            if not dataflow_adjacent(a, b):
                continue
            merged = a + b
            if internal_bytes(graph, merged, consumers, alignment) > local_budget:
                continue
            cand = groups[:gi] + [merged] + groups[gi + 2:]
            fused = fuse_groups(graph, cand)
            total = plan_records(
                fused.usage_records(alignment),
                mode=mode,
                strategy=strategy,
                graph_name=graph.name,
                cache=cache,
            ).total_size
            evaluations += 1
            if total < best_merge_total:
                best_merge, best_merge_total = gi, total
        if best_merge is None:
            break
        groups = (
            groups[:best_merge]
            + [groups[best_merge] + groups[best_merge + 1]]
            + groups[best_merge + 2:]
        )
        best_total = best_merge_total

    final = fuse_groups(graph, groups)
    plan = plan_records(
        final.usage_records(alignment),
        mode=mode,
        strategy=strategy,
        graph_name=graph.name,
        cache=cache,
    )
    return FusionSearchResult(
        graph=final,
        plan=plan,
        baseline_plan=baseline_plan,
        groups=tuple(tuple(g) for g in groups),
        internalized_bytes=sum(
            internal_bytes(graph, g, consumers, alignment)
            for g in groups
            if len(g) > 1
        ),
        evaluations=evaluations,
        cache_hits=cache.hits - hits0,
        cache_misses=cache.misses - misses0,
        wall_s=time.perf_counter() - wall0,
    )
