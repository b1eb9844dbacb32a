"""Prior-work baselines the paper compares against (§2, §6, Tables 1–2).

* ``naive``                — every intermediate tensor gets its own buffer.
* ``tflite_greedy_*``      — "Greedy" of Lee et al. 2019 (TFLite GPU
  delegate's GREEDY_IN_ORDER): tensors in execution (first_op) order, each
  assigned the free object with the closest size (prefer the smallest
  object >= size_t; else the largest smaller one, grown).
* ``min_cost_flow``        — Lee et al. 2019's min-cost-flow assignment for
  Shared Objects, reimplemented as a min-cost bipartite matching: each
  tensor takes its buffer either from a fresh allocation (cost size_t) or
  from a non-overlapping predecessor's object (cost = growth
  max(0, size_t - size_j)); chains of reuse form the shared objects.
* ``strip_packing_bestfit``— Sekiyama et al. 2018's profile-guided strip
  packing (best-fit decreasing): tensors in size-descending order, placed
  at the lowest feasible offset.

These are reimplementations from the cited papers' descriptions (sources
unavailable offline); the reproduction compares them against the paper's
reported numbers in EXPERIMENTS.md.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Sequence

from repro_torch.core.interval_set import BestFitArena
from repro_torch.core.offsets import OffsetAssignment
from repro_torch.core.records import TensorUsageRecord
from repro_torch.core.shared_objects import (
    SharedObject,
    SharedObjectsAssignment,
    _create_object,
    _new_assignment,
)


# ------------------------------------------------------------------ naive


def naive_shared_objects(
    records: Sequence[TensorUsageRecord],
) -> SharedObjectsAssignment:
    asn = _new_assignment("naive")
    for rec in sorted(records, key=lambda r: r.tensor_id):
        obj = _create_object(asn, rec)
        obj.assign(rec)
        asn.assignment[rec.tensor_id] = obj.object_id
    return asn


def naive_offsets(records: Sequence[TensorUsageRecord]) -> OffsetAssignment:
    offsets: dict[int, int] = {}
    cursor = 0
    for rec in sorted(records, key=lambda r: r.tensor_id):
        offsets[rec.tensor_id] = cursor
        cursor += rec.size
    return OffsetAssignment("naive", offsets, cursor)


# ------------------------------------------- TFLite GREEDY_IN_ORDER (Lee'19)


def tflite_greedy_in_order(
    records: Sequence[TensorUsageRecord],
) -> SharedObjectsAssignment:
    """Tensors in execution order; free objects pooled as their last user
    retires; closest-size object wins (prefer non-growing)."""
    asn = _new_assignment("tflite_greedy_in_order")
    order = sorted(records, key=lambda r: (r.first_op, -r.size, r.tensor_id))
    # (release_op, object_id) heap of busy objects
    busy: list[tuple[int, int]] = []
    free: set[int] = set()
    for rec in order:
        while busy and busy[0][0] < rec.first_op:
            _, oid = heapq.heappop(busy)
            free.add(oid)
        best_ge: SharedObject | None = None  # smallest object >= size
        best_lt: SharedObject | None = None  # largest object < size
        for oid in free:
            obj = asn.objects[oid]
            if obj.size >= rec.size:
                if best_ge is None or obj.size < best_ge.size:
                    best_ge = obj
            else:
                if best_lt is None or obj.size > best_lt.size:
                    best_lt = obj
        obj = best_ge or best_lt
        if obj is None:
            obj = _create_object(asn, rec)
        else:
            free.remove(obj.object_id)
        obj.assign(rec)
        asn.assignment[rec.tensor_id] = obj.object_id
        heapq.heappush(busy, (rec.last_op, obj.object_id))
    return asn


def tflite_greedy_in_order_offsets(
    records: Sequence[TensorUsageRecord],
) -> OffsetAssignment:
    """Lee'19 'Greedy' adapted to offsets: execution order + best-fit gap."""
    arena = BestFitArena()
    order = sorted(records, key=lambda r: (r.first_op, -r.size, r.tensor_id))
    for rec in order:
        arena.place(rec)
    return OffsetAssignment("tflite_greedy_in_order", arena.offsets, arena.total)


# ------------------------------------------------- min-cost flow (Lee'19)


class _MinCostFlow:
    """Successive-shortest-paths MCMF with SPFA (graphs here are small)."""

    def __init__(self, n: int):
        self.n = n
        self.graph: list[list[list[int]]] = [[] for _ in range(n)]
        # edge = [to, cap, cost, index_of_reverse]

    def add_edge(self, u: int, v: int, cap: int, cost: int) -> None:
        self.graph[u].append([v, cap, cost, len(self.graph[v])])
        self.graph[v].append([u, 0, -cost, len(self.graph[u]) - 1])

    def min_cost_flow(self, s: int, t: int, maxflow: int) -> int:
        total_cost = 0
        INF = 1 << 62
        while maxflow > 0:
            dist = [INF] * self.n
            in_q = [False] * self.n
            prevv = [-1] * self.n
            preve = [-1] * self.n
            dist[s] = 0
            queue = deque([s])
            in_q[s] = True
            while queue:
                u = queue.popleft()
                in_q[u] = False
                for i, e in enumerate(self.graph[u]):
                    v, cap, cost, _ = e
                    if cap > 0 and dist[u] + cost < dist[v]:
                        dist[v] = dist[u] + cost
                        prevv[v] = u
                        preve[v] = i
                        if not in_q[v]:
                            queue.append(v)
                            in_q[v] = True
            if dist[t] >= INF:
                break
            d = maxflow
            v = t
            while v != s:
                d = min(d, self.graph[prevv[v]][preve[v]][1])
                v = prevv[v]
            v = t
            while v != s:
                e = self.graph[prevv[v]][preve[v]]
                e[1] -= d
                self.graph[e[0]][e[3]][1] += d
                v = prevv[v]
            total_cost += d * dist[t]
            maxflow -= d
        return total_cost


def min_cost_flow_assignment(
    records: Sequence[TensorUsageRecord],
) -> SharedObjectsAssignment:
    """Shared-objects assignment via min-cost matching (Lee'19 style).

    Node layout: source, sink, provider_i (tensor i's buffer can be handed
    off to one later tensor), consumer_i (tensor i needs one buffer).
    * source → consumer_i, cap 1, cost size_i          (fresh object)
    * provider_j → consumer_i, cap 1, cost max(0, size_i - size_j)
      iff intervals disjoint and j executes first       (reuse + growth)
    * source → provider_j cap 1 cost 0; consumer_i → sink cap 1 cost 0.
    Reuse chains are decoded into shared objects.
    """
    recs = sorted(records, key=lambda r: (r.first_op, r.tensor_id))
    n = len(recs)
    S, T = 2 * n, 2 * n + 1
    mcf = _MinCostFlow(2 * n + 2)
    for i, ri in enumerate(recs):
        mcf.add_edge(S, n + i, 1, 0)  # provider availability
        mcf.add_edge(S, i, 1, ri.size)  # fresh object for consumer i
        mcf.add_edge(i, T, 1, 0)
        for j, rj in enumerate(recs):
            if j == i:
                continue
            if rj.last_op < ri.first_op:  # j fully retires before i starts
                mcf.add_edge(n + j, i, 1, max(0, ri.size - rj.size))
    mcf.min_cost_flow(S, T, n)

    # decode: consumer i took provider j iff edge (n+j) -> i has flow
    take_from: dict[int, int] = {}
    for j in range(n):
        for e in mcf.graph[n + j]:
            v, cap, cost, _ = e
            if v < n and cap == 0:  # saturated forward edge
                take_from[v] = j
                break
    asn = _new_assignment("min_cost_flow")
    # walk chains from roots (consumers with no provider)
    chain_next: dict[int, int] = {j: i for i, j in take_from.items()}
    roots = [i for i in range(n) if i not in take_from]
    for root in roots:
        obj = _create_object(asn, recs[root])
        i = root
        while True:
            rec = recs[i]
            obj.assign(rec)
            asn.assignment[rec.tensor_id] = obj.object_id
            if i in chain_next:
                i = chain_next[i]
            else:
                break
    return asn


# ------------------------------------- strip packing best-fit (Sekiyama'18)


def strip_packing_bestfit(
    records: Sequence[TensorUsageRecord],
) -> OffsetAssignment:
    """Best-fit-decreasing strip packing: size-descending order, each tensor
    placed at the lowest feasible offset (first-fit over the gap list)."""
    arena = BestFitArena(first_fit=True)
    order = sorted(records, key=lambda r: (-r.size, r.first_op, r.tensor_id))
    for rec in order:
        arena.place(rec)
    return OffsetAssignment("strip_packing_bestfit", arena.offsets, arena.total)
