"""Exact solvers for small instances (beyond-paper extension).

The paper reports distances to its *lower bounds* but the bounds may be
unachievable (§4.1), so the greedy strategies' true optimality gap is
unknown. These branch-and-bound solvers compute exact optima on small
graphs (≲ 10 tensors) so the test-suite and EXPERIMENTS.md §Beyond can
quantify the gap precisely.

Completeness arguments:
* Shared Objects: processing tensors in any fixed size-descending order
  and assigning each to an existing compatible object or a fresh one
  enumerates every partition into interval-compatible groups (a fresh
  object's size equals its largest = first-assigned tensor).
* Offsets: bottom-left normalization — in some optimal packing every
  tensor sits at offset 0 or flush against the end of a time-overlapping
  tensor with a strictly lower offset; adding tensors in non-decreasing
  offset order therefore only needs candidates {0} ∪ {ends of placed
  overlapping tensors} with offset >= the last placed offset.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.records import (
    TensorUsageRecord,
    offsets_lower_bound,
    shared_objects_lower_bound,
)


def optimal_shared_objects_total(
    records: Sequence[TensorUsageRecord], limit_nodes: int = 2_000_000
) -> int:
    """Exact minimum total shared-object size (branch and bound)."""
    recs = sorted(records, key=lambda r: (-r.size, r.first_op, r.tensor_id))
    n = len(recs)
    if n == 0:
        return 0
    lb = shared_objects_lower_bound(recs)
    best = sum(r.size for r in recs)
    nodes = 0

    def dfs(i: int, objects: list[list[TensorUsageRecord]], total: int) -> None:
        nonlocal best, nodes
        nodes += 1
        if nodes > limit_nodes or total >= best or best == lb:
            return
        if i == n:
            best = total
            return
        rec = recs[i]
        seen: set[frozenset] = set()
        for obj in objects:
            if any(x.overlaps(rec) for x in obj):
                continue
            # true symmetry break: identical occupancy sets are equivalent
            key = frozenset((x.first_op, x.last_op, x.size) for x in obj)
            if key in seen:
                continue
            seen.add(key)
            obj.append(rec)
            dfs(i + 1, objects, total)
            obj.pop()
        objects.append([rec])
        dfs(i + 1, objects, total + rec.size)  # sizes non-increasing
        objects.pop()

    dfs(0, [], 0)
    return best


def optimal_offsets_total(
    records: Sequence[TensorUsageRecord], limit_nodes: int = 2_000_000
) -> int:
    """Exact minimum arena size (branch and bound, bottom-left order)."""
    recs = list(records)
    n = len(recs)
    if n == 0:
        return 0
    lb = offsets_lower_bound(recs)
    best = sum(r.size for r in recs)
    nodes = 0
    placed: list[tuple[TensorUsageRecord, int]] = []

    def feasible(rec: TensorUsageRecord, off: int) -> bool:
        for x, xoff in placed:
            if rec.overlaps(x) and not (
                off + rec.size <= xoff or xoff + x.size <= off
            ):
                return False
        return True

    def dfs(used: int, last_off: int, height: int) -> None:
        nonlocal best, nodes
        nodes += 1
        if nodes > limit_nodes or height >= best or best == lb:
            return
        if used == (1 << n) - 1:
            best = height
            return
        tried: set[tuple[int, int, int, int]] = set()
        for i in range(n):
            if used & (1 << i):
                continue
            rec = recs[i]
            candidates = {0}
            for x, xoff in placed:
                if rec.overlaps(x):
                    candidates.add(xoff + x.size)
            for off in sorted(candidates):
                if off < last_off:
                    continue  # non-decreasing placement order (see docstring)
                if off + rec.size >= best:
                    break
                key = (rec.first_op, rec.last_op, rec.size, off)
                if key in tried:
                    continue  # identical tensors at the same offset
                if not feasible(rec, off):
                    continue
                tried.add(key)
                placed.append((rec, off))
                dfs(used | (1 << i), off, max(height, off + rec.size))
                placed.pop()

    dfs(0, 0, 0)
    return best
