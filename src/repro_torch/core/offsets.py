"""Offset Calculation strategies (paper §5), copied from the reference.

One flat memory arena; each intermediate tensor gets a byte offset. Tensors
with intersecting usage intervals must occupy disjoint byte ranges.
Objective: minimize ``max(offset_t + size_t)``.

* ``greedy_by_size_offsets``    — §5.2, Algorithm 3 (best-fit gap search)
* ``greedy_by_breadth_offsets`` — §5.3 (operator-breadth outer order, same
  gap logic)
* ``strip_packing_bestfit``     — Sekiyama'18 strip packing (the
  reference keeps it in ``core/baselines.py``)

These three are the reference's ``auto`` offsets portfolio, so the
port's ``auto`` plan is the JAX package's, byte for byte.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.core.interval_set import BestFitArena
from repro_torch.core.records import (
    TensorUsageRecord,
    operator_breadths,
    operator_profiles,
)


@dataclasses.dataclass
class OffsetAssignment:
    strategy: str
    # tensor_id -> byte offset in the arena
    offsets: dict[int, int]
    total_size: int

    def offset_of(self, tensor_id: int) -> int:
        return self.offsets[tensor_id]


def greedy_by_size_offsets(
    records: Sequence[TensorUsageRecord],
) -> OffsetAssignment:
    """Paper §5.2, Algorithm 3."""
    arena = BestFitArena()
    order = sorted(records, key=lambda r: (-r.size, r.first_op, r.tensor_id))
    for rec in order:
        arena.place(rec)
    return OffsetAssignment("greedy_by_size", arena.offsets, arena.total)


def greedy_by_breadth_offsets(
    records: Sequence[TensorUsageRecord],
) -> OffsetAssignment:
    """Paper §5.3: operators in non-increasing breadth order; within each
    profile, unassigned tensors largest-first; same best-fit gap logic."""
    arena = BestFitArena()
    breadths = operator_breadths(records)
    profiles = operator_profiles(records)
    op_order = sorted(range(len(breadths)), key=lambda i: (-breadths[i], i))
    for op_idx in op_order:
        for rec in profiles[op_idx]:  # size-descending inside the profile
            if rec.tensor_id in arena.offsets:
                continue
            arena.place(rec)
    return OffsetAssignment("greedy_by_breadth", arena.offsets, arena.total)


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


STRATEGIES: dict[str, Callable[[Sequence[TensorUsageRecord]], OffsetAssignment]] = {
    "greedy_by_size": greedy_by_size_offsets,
    "greedy_by_breadth": greedy_by_breadth_offsets,
    "strip_packing_bestfit": strip_packing_bestfit,
}
