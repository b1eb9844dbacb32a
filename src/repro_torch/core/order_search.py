"""Topological-order search driven by the cached planner (paper §7.1).

The usage intervals — and therefore every bound and every strategy result —
depend on the topological sort chosen for the DAG. The paper fixes the
order; §7.1 proposes optimizing it. PR 1 made ``plan_records`` near-free
through the content-addressed plan cache precisely so this outer loop can
call it thousands of times, so the search objective here is the REAL
planned footprint (``MemoryPlan.total_size``), not a lower bound that may
be unachievable.

* ``memory_aware_topo_order`` — a greedy scheduler: among ready ops, pick
  the one minimizing live-set growth (frees the most bytes, then adds the
  fewest). This is the classic Bruno–Sethi-style heuristic for
  register-pressure-aware scheduling.
* ``IncrementalRecords`` — maintains the usage records of a graph under a
  mutable topological order. An adjacent swap re-derives the records of
  only the tensors touched by the two swapped ops (O(affected) instead of
  rebuilding and re-validating the whole graph per candidate).
* ``search_order`` / ``simulated_annealing_order`` — local search over
  adjacent-swap neighborhoods; every candidate is costed by planning it
  for real, with repeat record-multisets served from the plan cache.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import TYPE_CHECKING, Callable, Literal, Sequence

from repro_torch.core import plan_io
from repro_torch.core.graph import Graph
from repro_torch.core.records import (
    DEFAULT_ALIGNMENT,
    TensorUsageRecord,
    align,
    offsets_lower_bound,
)

if TYPE_CHECKING:  # planner imports stay late to keep this module light
    from repro_torch.core.planner import MemoryPlan

Objective = Literal["plan", "lower_bound"]


def _dependencies(graph: Graph) -> tuple[list[set[int]], list[set[int]]]:
    """preds[i], succs[i] as op-index sets, via tensor def/use."""
    producer: dict[int, int] = {}
    for idx, op in enumerate(graph.ops):
        for t in op.outputs:
            producer[t] = idx
    preds: list[set[int]] = [set() for _ in graph.ops]
    succs: list[set[int]] = [set() for _ in graph.ops]
    for idx, op in enumerate(graph.ops):
        for t in op.inputs:
            if t in producer and producer[t] != idx:
                preds[idx].add(producer[t])
                succs[producer[t]].add(idx)
    return preds, succs


def _reorder(graph: Graph, order: Sequence[int]) -> Graph:
    """Reindex ``graph.ops`` by ``order``. The callers below only produce
    orders that are topologically valid by construction (greedy ready-list
    scheduling, dependency-checked adjacent swaps), so the input graph is
    validated ONCE up front and candidates are not re-validated — that
    per-candidate ``Graph.validate()`` made the old search loop
    O(iters × graph)."""
    return Graph(
        name=graph.name,
        ops=[graph.ops[i] for i in order],
        tensors=graph.tensors,
        boundary_ids=graph.boundary_ids,
    )


class IncrementalRecords:
    """Usage records of ``graph`` under a mutable topological order.

    ``swap(k)`` exchanges the ops at order positions ``k`` and ``k+1`` and
    updates only the records of tensors touched by those two ops — every
    other tensor's interval is untouched by an adjacent transposition.
    ``records()`` therefore always equals
    ``_reorder(graph, self.order).usage_records(alignment)`` (the property
    tests assert this equivalence on random swap sequences).
    """

    def __init__(
        self,
        graph: Graph,
        alignment: int = DEFAULT_ALIGNMENT,
        *,
        validate: bool = True,
    ):
        if validate:
            graph.validate()
        self.graph = graph
        n = len(graph.ops)
        self.order: list[int] = list(range(n))  # position -> op index
        self._pos: list[int] = list(range(n))  # op index -> position
        touch: dict[int, set[int]] = {}
        for i, op in enumerate(graph.ops):
            for t in (*op.inputs, *op.outputs):
                touch.setdefault(t, set()).add(i)
        self._touch: dict[int, tuple[int, ...]] = {
            t: tuple(sorted(ops))
            for t, ops in touch.items()
            if t not in graph.boundary_ids
        }
        self._size = {
            t: align(graph.tensors[t].nbytes, alignment) for t in self._touch
        }
        self._span: dict[int, tuple[int, int]] = {}
        # record objects are cached per tensor (insertion order = sorted
        # tensor id) so a swap only reconstructs the affected ones and
        # ``records()`` is a plain list copy
        self._rec: dict[int, TensorUsageRecord] = {}
        for t in sorted(self._touch):
            ps = [self._pos[i] for i in self._touch[t]]
            span = (min(ps), max(ps))
            self._span[t] = span
            self._rec[t] = TensorUsageRecord(
                first_op=span[0], last_op=span[1],
                size=self._size[t], tensor_id=t,
            )
        self._preds, _ = _dependencies(graph)

    def can_swap(self, k: int) -> bool:
        """True iff swapping positions k, k+1 preserves topological order
        (no producer/consumer edge between the two ops)."""
        return self.order[k] not in self._preds[self.order[k + 1]]

    def swap(self, k: int) -> list[int]:
        """Swap order positions k and k+1; returns the tensor ids whose
        usage interval changed. Self-inverse: ``swap(k)`` twice restores
        both the order and every record."""
        a, b = self.order[k], self.order[k + 1]
        self.order[k], self.order[k + 1] = b, a
        self._pos[a], self._pos[b] = k + 1, k
        changed = []
        ops = self.graph.ops
        for t in {*ops[a].inputs, *ops[a].outputs,
                  *ops[b].inputs, *ops[b].outputs}:
            touched = self._touch.get(t)
            if touched is None:  # boundary tensor: no record
                continue
            ps = [self._pos[i] for i in touched]
            span = (min(ps), max(ps))
            if span != self._span[t]:
                self._span[t] = span
                self._rec[t] = TensorUsageRecord(
                    first_op=span[0], last_op=span[1],
                    size=self._size[t], tensor_id=t,
                )
                changed.append(t)
        return changed

    def records(self) -> list[TensorUsageRecord]:
        return list(self._rec.values())

    def reordered_graph(self) -> Graph:
        return _reorder(self.graph, self.order)


def memory_aware_order(graph: Graph, *, validate: bool = True) -> list[int]:
    """Greedy order (op indices): always schedule the ready op with the
    best (freed - added) byte delta; ties broken by smaller added bytes
    then original index."""
    if validate:
        graph.validate()
    preds, succs = _dependencies(graph)
    n = len(graph.ops)
    remaining_uses: dict[int, int] = {}
    for op in graph.ops:
        for t in op.inputs:
            remaining_uses[t] = remaining_uses.get(t, 0) + 1
    indeg = [len(p) for p in preds]
    ready = sorted(i for i in range(n) if indeg[i] == 0)
    order: list[int] = []
    uses = dict(remaining_uses)

    def delta(i: int) -> tuple[int, int, int]:
        op = graph.ops[i]
        freed = sum(
            graph.tensors[t].nbytes
            for t in set(op.inputs)
            if t not in graph.boundary_ids and uses.get(t, 0) == op.inputs.count(t)
        )
        added = sum(
            graph.tensors[t].nbytes
            for t in op.outputs
            if t not in graph.boundary_ids
        )
        return (added - freed, added, i)

    while ready:
        ready.sort(key=delta)
        i = ready.pop(0)
        order.append(i)
        for t in graph.ops[i].inputs:
            if t in uses:
                uses[t] -= 1
        for j in succs[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                ready.append(j)
    assert len(order) == n, "graph has a cycle"
    return order


def memory_aware_topo_order(graph: Graph) -> Graph:
    """Greedy live-set scheduler; see :func:`memory_aware_order`."""
    return _reorder(graph, memory_aware_order(graph))


@dataclasses.dataclass
class OrderSearchResult:
    """Outcome of :func:`search_order`: the best order found, its plan,
    the default-order baseline plan, and search-loop statistics."""

    graph: Graph
    plan: "MemoryPlan"
    baseline_plan: "MemoryPlan"
    order: list[int]
    evaluations: int
    cache_hits: int
    cache_misses: int
    wall_s: float

    @property
    def delta_bytes(self) -> int:
        return self.baseline_plan.total_size - self.plan.total_size

    @property
    def cache_hit_rate(self) -> float:
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def provenance(self) -> dict:
        """Deterministic compile-time metadata for plan artifacts
        (:mod:`repro_torch.core.unified` merges this into bundle provenance)."""
        return {
            "order_total_bytes": self.plan.total_size,
            "order_evaluations": self.evaluations,
            "order_cache_hits": self.cache_hits,
        }


def _make_objective(
    objective: Objective,
    mode: str,
    strategy: str,
    cache: "plan_io.PlanCache",
) -> Callable[[Sequence[TensorUsageRecord]], int]:
    if objective == "lower_bound":
        return offsets_lower_bound
    from repro_torch.core.planner import plan_records  # late: planner is heavier

    def cost(records: Sequence[TensorUsageRecord]) -> int:
        return plan_records(
            records, mode=mode, strategy=strategy, cache=cache
        ).total_size

    return cost


def search_order(
    graph: Graph,
    *,
    iters: int = 2000,
    seed: int = 0,
    t0: float = 0.15,
    mode: str = "offsets",
    strategy: str = "auto",
    objective: Objective = "plan",
    cache: "plan_io.PlanCache | None" = None,
    start: Literal["memory_aware", "identity"] = "memory_aware",
    alignment: int = DEFAULT_ALIGNMENT,
) -> OrderSearchResult:
    """Anneal over the adjacent-swap neighborhood of topological orders,
    costing every candidate with the real (cached) planner.

    The identity order is always evaluated first and kept as the
    incumbent, so the returned plan is never worse than the default-order
    baseline. ``start="memory_aware"`` additionally seeds the walk from
    the greedy live-set order. Deterministic for a fixed seed.
    """
    from repro_torch.core.planner import plan_records

    wall0 = time.perf_counter()
    cache = cache if cache is not None else plan_io.PlanCache()
    hits0, misses0 = cache.hits, cache.misses
    cost_of = _make_objective(objective, mode, strategy, cache)
    evaluations = 0

    graph.validate()  # once; candidates below are valid by construction
    n = len(graph.ops)
    identity_records = graph.usage_records(alignment)

    baseline_plan = plan_records(
        identity_records,
        mode=mode,
        strategy=strategy,
        graph_name=graph.name,
        cache=cache,
    )
    evaluations += 1
    best_order = list(range(n))
    best = (
        baseline_plan.total_size
        if objective == "plan"
        else offsets_lower_bound(identity_records)
    )

    # seed the walk: replay the greedy order as adjacent swaps is overkill —
    # just build the incremental state around it directly
    if start == "memory_aware" and n > 1:
        greedy = memory_aware_order(graph, validate=False)
        inc = IncrementalRecords(
            _reorder(graph, greedy), alignment, validate=False
        )
        # positions refer to the reseeded graph; map back through `greedy`
        seed_map = greedy
    else:
        inc = IncrementalRecords(graph, alignment, validate=False)
        seed_map = list(range(n))

    cur = cost_of(inc.records())
    evaluations += 1
    if cur < best:
        best = cur
        best_order = [seed_map[i] for i in inc.order]

    rng = random.Random(seed)
    for it in range(iters):
        if n < 2:
            break
        k = rng.randrange(n - 1)
        if not inc.can_swap(k):
            continue
        if not inc.swap(k):
            # no interval changed — identical record multiset, same cost;
            # keep the (equivalent) swapped order and move on
            continue
        new = cost_of(inc.records())
        evaluations += 1
        temp = t0 * (1.0 - it / iters) + 1e-9
        if new <= cur or rng.random() < math.exp(
            -(new - cur) / (temp * max(cur, 1))
        ):
            cur = new
            if cur < best:
                best = cur
                best_order = [seed_map[i] for i in inc.order]
        else:
            inc.swap(k)  # revert

    result_graph = _reorder(graph, best_order)
    plan = plan_records(
        result_graph.usage_records(alignment),
        mode=mode,
        strategy=strategy,
        graph_name=graph.name,
        cache=cache,
    )
    if plan.total_size > baseline_plan.total_size:
        # a proxy objective (lower_bound) can prefer an order whose REAL
        # plan is larger; the never-worse contract holds regardless
        result_graph, plan, best_order = graph, baseline_plan, list(range(n))
    return OrderSearchResult(
        graph=result_graph,
        plan=plan,
        baseline_plan=baseline_plan,
        order=best_order,
        evaluations=evaluations,
        cache_hits=cache.hits - hits0,
        cache_misses=cache.misses - misses0,
        wall_s=time.perf_counter() - wall0,
    )


def simulated_annealing_order(
    graph: Graph,
    *,
    iters: int = 2000,
    seed: int = 0,
    t0: float = 0.15,
    objective: Objective = "plan",
    mode: str = "offsets",
    strategy: str = "auto",
    cache: "plan_io.PlanCache | None" = None,
) -> Graph:
    """Back-compat wrapper around :func:`search_order` returning just the
    reordered graph (annealed from the identity order)."""
    return search_order(
        graph,
        iters=iters,
        seed=seed,
        t0=t0,
        mode=mode,
        strategy=strategy,
        objective=objective,
        cache=cache,
        start="identity",
    ).graph
