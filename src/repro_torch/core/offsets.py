"""Offset Calculation strategies (paper §5).

One flat memory arena; each intermediate tensor gets a byte offset. Tensors
with intersecting usage intervals must occupy disjoint byte ranges.
Objective: minimize ``max(offset_t + size_t)``.

* ``greedy_by_size_offsets``    — §5.2, Algorithm 3 (best-fit gap search)
* ``greedy_by_breadth_offsets`` — §5.3 (operator-breadth outer order, same
  gap logic)
* ``from_shared_objects``       — §5: any Shared Objects solution converts
  by laying the objects out contiguously.

The gap search runs on :class:`repro_torch.core.interval_set.BestFitArena`: an
interval tree narrows each placement to the already-placed records that
actually overlap the new tensor's lifetime, instead of the seed's rescan
of every placed record (O(n²) total, preserved as the oracle in
:mod:`repro_torch.core.reference`). Placement results are byte-identical.
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
from repro_torch.core.shared_objects import SharedObjectsAssignment


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


def from_shared_objects(asn: SharedObjectsAssignment) -> OffsetAssignment:
    """Lay shared objects out contiguously (paper §5: SO ⇒ offsets; the
    converse does not hold)."""
    base: dict[int, int] = {}
    cursor = 0
    for obj in asn.objects:
        base[obj.object_id] = cursor
        cursor += obj.size
    offsets = {tid: base[oid] for tid, oid in asn.assignment.items()}
    return OffsetAssignment(f"{asn.strategy}+contiguous", offsets, cursor)


STRATEGIES: dict[str, Callable[[Sequence[TensorUsageRecord]], OffsetAssignment]] = {
    "greedy_by_size": greedy_by_size_offsets,
    "greedy_by_breadth": greedy_by_breadth_offsets,
}
