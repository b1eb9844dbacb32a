"""Beyond-paper strategies.

``greedy_by_conflict``: the paper orders by size (GBS) or operator breadth
(GBB). Interval-graph coloring theory suggests a third signal: a tensor's
*conflict mass* — the total size of tensors whose intervals overlap it —
measures how constrained its placement is. Ordering by (conflict mass,
size) descending and assigning best-fit objects places the most
constrained tensors while the object set is still flexible.

``offsets_best_of_all``: portfolio planner — run every offsets strategy
(ours + baselines + converted shared-objects solutions) and keep the
minimum; generalizes the paper's §6 "evaluate both" advice.
"""

from __future__ import annotations

import bisect
from typing import Sequence

from repro_torch.core import baselines, offsets, shared_objects
from repro_torch.core.offsets import OffsetAssignment, from_shared_objects
from repro_torch.core.records import TensorUsageRecord
from repro_torch.core.shared_objects import (
    SharedObjectsAssignment,
    _new_assignment,
    _ObjectPool,
    _pool_select_is_better,
)


def conflict_mass(records: Sequence[TensorUsageRecord]) -> dict[int, int]:
    """For each tensor, the total size of the tensors overlapping it.

    Sorted-event formulation (no pairwise scan): ``b`` overlaps ``a`` iff
    ``first_b <= last_a`` and ``last_b >= first_a``, so the overlap mass is
    (sum of sizes with first <= last_a) − (sum of sizes with last < first_a)
    − size_a, each term a prefix sum over a sorted key array.
    """
    firsts = sorted((r.first_op, r.size) for r in records)
    lasts = sorted((r.last_op, r.size) for r in records)
    first_keys = [f for f, _ in firsts]
    last_keys = [l for l, _ in lasts]
    first_cum = [0]
    for _, s in firsts:
        first_cum.append(first_cum[-1] + s)
    last_cum = [0]
    for _, s in lasts:
        last_cum.append(last_cum[-1] + s)
    out: dict[int, int] = {}
    for r in records:
        started = first_cum[bisect.bisect_right(first_keys, r.last_op)]
        retired = last_cum[bisect.bisect_left(last_keys, r.first_op)]
        out[r.tensor_id] = started - retired - r.size
    return out


def greedy_by_conflict(
    records: Sequence[TensorUsageRecord],
) -> SharedObjectsAssignment:
    records = list(records)
    conflict = conflict_mass(records)
    order = sorted(
        records,
        key=lambda r: (-(conflict[r.tensor_id] + r.size), -r.size, r.tensor_id),
    )
    asn = _new_assignment("greedy_by_conflict")
    pool = _ObjectPool()
    for rec in order:
        best = _pool_select_is_better(asn, pool, rec)
        asn.assignment[rec.tensor_id] = best.object_id
    return asn


def offsets_best_of_all(
    records: Sequence[TensorUsageRecord],
) -> OffsetAssignment:
    cands = [
        offsets.greedy_by_size_offsets(records),
        offsets.greedy_by_breadth_offsets(records),
        baselines.strip_packing_bestfit(records),
        baselines.tflite_greedy_in_order_offsets(records),
        from_shared_objects(shared_objects.greedy_by_size_improved(records)),
        from_shared_objects(greedy_by_conflict(records)),
    ]
    best = min(cands, key=lambda a: a.total_size)
    return OffsetAssignment("best_of_all:" + best.strategy, best.offsets, best.total_size)
