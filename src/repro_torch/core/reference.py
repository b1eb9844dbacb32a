"""FROZEN reference planner — the differential-testing oracle.

These are the seed repository's naive implementations of the paper's
strategies, preserved verbatim-in-spirit when the production planner moved
to the shared interval-overlap engine (:mod:`repro_torch.core.interval_set`).
They re-derive *everything* locally — their own operator profiles, breadths
and positional maximums, their own per-object interval walks, their own
full-scan best-fit — so a bug in the fast engine cannot hide behind shared
code.

Contract (enforced by ``tests/test_differential_planner.py``): for every
strategy named in ``REFERENCE_SHARED_OBJECT_STRATEGIES`` /
``REFERENCE_OFFSET_STRATEGIES``, the fast implementation in
:mod:`repro_torch.core.shared_objects` / :mod:`repro_torch.core.offsets` /
:mod:`repro_torch.core.baselines` must produce the **identical** assignment /
offsets (and therefore identical ``total_size``) on any record set. The
fast paths are pure data-structure swaps; tie-breaking is preserved
exactly.

DO NOT "improve" this module. Its only job is to stay simple, obviously
correct, and byte-for-byte stable; performance is irrelevant (it is
O(k·n²) by design). New strategies get a frozen twin here *before* their
fast implementation lands.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Sequence

from repro_torch.core.offsets import OffsetAssignment
from repro_torch.core.records import TensorUsageRecord
from repro_torch.core.shared_objects import SharedObjectsAssignment

# --------------------------------------------------------------- profiles
# Local copies: the oracle must not share derived-quantity code with the
# fast engine (records.py now computes breadths by event sweep).


def _num_operators(records: Sequence[TensorUsageRecord]) -> int:
    return 0 if not records else 1 + max(r.last_op for r in records)


def _operator_profiles(
    records: Sequence[TensorUsageRecord],
) -> list[list[TensorUsageRecord]]:
    profiles: list[list[TensorUsageRecord]] = [
        [] for _ in range(_num_operators(records))
    ]
    for r in records:
        for op in range(r.first_op, r.last_op + 1):
            profiles[op].append(r)
    for p in profiles:
        p.sort(key=lambda r: (-r.size, r.tensor_id))
    return profiles


def _operator_breadths(records: Sequence[TensorUsageRecord]) -> list[int]:
    breadths = [0] * _num_operators(records)
    for r in records:
        for op in range(r.first_op, r.last_op + 1):
            breadths[op] += r.size
    return breadths


def _positional_maximums(records: Sequence[TensorUsageRecord]) -> list[int]:
    profiles = _operator_profiles(records)
    depth = max((len(p) for p in profiles), default=0)
    return [
        max(p[i].size for p in profiles if len(p) > i) for i in range(depth)
    ]


# ---------------------------------------------------- naive shared object


@dataclasses.dataclass
class _RefObject:
    """The seed ``SharedObject``: sorted interval list + neighborhood walk."""

    object_id: int
    size: int
    intervals: list[tuple[int, int, int]] = dataclasses.field(default_factory=list)

    def fits(self, rec: TensorUsageRecord) -> bool:
        starts = [iv[0] for iv in self.intervals]
        idx = bisect.bisect_right(starts, rec.last_op)
        for i in range(idx - 1, -1, -1):
            f, l, _ = self.intervals[i]
            if l >= rec.first_op:
                return False
        return True

    def assign(self, rec: TensorUsageRecord) -> None:
        starts = [iv[0] for iv in self.intervals]
        idx = bisect.bisect_left(starts, rec.first_op)
        self.intervals.insert(idx, (rec.first_op, rec.last_op, rec.tensor_id))
        self.size = max(self.size, rec.size)

    def gap_to(self, rec: TensorUsageRecord) -> int:
        if not self.intervals:
            return 1 << 60
        best = 1 << 60
        for f, l, _ in self.intervals:
            if l < rec.first_op:
                best = min(best, rec.first_op - l - 1)
            elif f > rec.last_op:
                best = min(best, f - rec.last_op - 1)
        return best


def _new_assignment(strategy: str) -> SharedObjectsAssignment:
    return SharedObjectsAssignment(strategy=strategy, objects=[], assignment={})


def _create_object(asn: SharedObjectsAssignment, rec: TensorUsageRecord) -> _RefObject:
    obj = _RefObject(object_id=len(asn.objects), size=rec.size)
    asn.objects.append(obj)  # type: ignore[arg-type]
    return obj


# ------------------------------------------------ shared-objects oracles


def greedy_by_size(records: Sequence[TensorUsageRecord]) -> SharedObjectsAssignment:
    """Seed Greedy-by-Size (paper §4.3 Algorithm 2), full object scan."""
    asn = _new_assignment("greedy_by_size")
    order = sorted(records, key=lambda r: (-r.size, r.first_op, r.tensor_id))
    for rec in order:
        best: _RefObject | None = None
        for obj in asn.objects:
            if obj.fits(rec) and (best is None or obj.size < best.size):
                best = obj
        if best is None:
            best = _create_object(asn, rec)
        best.assign(rec)
        asn.assignment[rec.tensor_id] = best.object_id
    return asn


def greedy_by_breadth(records: Sequence[TensorUsageRecord]) -> SharedObjectsAssignment:
    """Seed Greedy-by-Breadth (paper §4.2 Algorithm 1)."""
    asn = _new_assignment("greedy_by_breadth")
    breadths = _operator_breadths(records)
    profiles = _operator_profiles(records)
    op_order = sorted(range(len(breadths)), key=lambda i: (-breadths[i], i))
    for op_idx in op_order:
        for rec in profiles[op_idx]:
            if rec.tensor_id in asn.assignment:
                continue
            best: _RefObject | None = None
            for obj in asn.objects:
                if not obj.fits(rec):
                    continue
                if best is None:
                    best = obj
                    continue
                if best.size < rec.size:
                    if obj.size > best.size:
                        best = obj
                else:
                    if rec.size <= obj.size < best.size:
                        best = obj
            if best is None:
                best = _create_object(asn, rec)
            best.assign(rec)
            asn.assignment[rec.tensor_id] = best.object_id
    return asn


def _stages_by_positional_maximums(
    records: Sequence[TensorUsageRecord],
) -> list[list[TensorUsageRecord]]:
    pms = sorted(set(_positional_maximums(records)), reverse=True)
    recs = sorted(records, key=lambda r: (-r.size, r.first_op, r.tensor_id))
    stages: list[list[TensorUsageRecord]] = []
    for i, pm in enumerate(pms):
        eq = [r for r in recs if r.size == pm]
        if eq:
            stages.append(eq)
        lo = pms[i + 1] if i + 1 < len(pms) else 0
        mid = [r for r in recs if lo < r.size < pm]
        if mid:
            stages.append(mid)
    return stages


def _greedy_by_size_improved_staged(
    records: Sequence[TensorUsageRecord],
) -> SharedObjectsAssignment:
    asn = _new_assignment("greedy_by_size_improved")
    for stage in _stages_by_positional_maximums(records):
        pending = list(stage)
        while pending:
            best_pair: tuple[int, TensorUsageRecord, _RefObject] | None = None
            for rec in pending:
                for obj in asn.objects:
                    if not obj.fits(rec):
                        continue
                    gap = obj.gap_to(rec)
                    if best_pair is None or gap < best_pair[0]:
                        best_pair = (gap, rec, obj)
            if best_pair is None:
                pending.sort(key=lambda r: (-r.size, r.first_op, r.tensor_id))
                rec = pending.pop(0)
                obj = _create_object(asn, rec)
                obj.assign(rec)
                asn.assignment[rec.tensor_id] = obj.object_id
            else:
                _, rec, obj = best_pair
                obj.assign(rec)
                asn.assignment[rec.tensor_id] = obj.object_id
                pending.remove(rec)
    return asn


def greedy_by_size_improved(
    records: Sequence[TensorUsageRecord],
) -> SharedObjectsAssignment:
    """Seed Greedy-by-Size-Improved (paper §4.4): best of staged / plain."""
    staged = _greedy_by_size_improved_staged(records)
    plain = greedy_by_size(records)
    if plain.total_size < staged.total_size:
        return SharedObjectsAssignment(
            strategy="greedy_by_size_improved",
            objects=plain.objects,
            assignment=plain.assignment,
        )
    return staged


# ------------------------------------------------------- offsets oracles


def _best_fit_offset(
    rec: TensorUsageRecord,
    allocated: list[TensorUsageRecord],
    offsets: dict[int, int],
) -> int:
    """Seed Algorithm 3 L.7–20: full scan over ALL allocated records."""
    prev_offset = 0
    best_offset: int | None = None
    smallest_gap = None
    for x in allocated:
        if rec.overlaps(x):
            x_off = offsets[x.tensor_id]
            gap = x_off - prev_offset
            if gap >= rec.size and (smallest_gap is None or gap < smallest_gap):
                smallest_gap = gap
                best_offset = prev_offset
            prev_offset = max(prev_offset, x_off + x.size)
    if best_offset is None:
        best_offset = prev_offset
    return best_offset


def greedy_by_size_offsets(records: Sequence[TensorUsageRecord]) -> OffsetAssignment:
    """Seed Greedy-by-Size offsets (paper §5.2 Algorithm 3)."""
    offsets: dict[int, int] = {}
    allocated: list[TensorUsageRecord] = []
    total = 0
    order = sorted(records, key=lambda r: (-r.size, r.first_op, r.tensor_id))
    for rec in order:
        off = _best_fit_offset(rec, allocated, offsets)
        offsets[rec.tensor_id] = off
        total = max(total, off + rec.size)
        allocated.append(rec)
        allocated.sort(key=lambda r: (offsets[r.tensor_id], r.tensor_id))
    return OffsetAssignment("greedy_by_size", offsets, total)


def greedy_by_breadth_offsets(records: Sequence[TensorUsageRecord]) -> OffsetAssignment:
    """Seed Greedy-by-Breadth offsets (paper §5.3)."""
    offsets: dict[int, int] = {}
    allocated: list[TensorUsageRecord] = []
    total = 0
    breadths = _operator_breadths(records)
    profiles = _operator_profiles(records)
    op_order = sorted(range(len(breadths)), key=lambda i: (-breadths[i], i))
    for op_idx in op_order:
        for rec in profiles[op_idx]:
            if rec.tensor_id in offsets:
                continue
            off = _best_fit_offset(rec, allocated, offsets)
            offsets[rec.tensor_id] = off
            total = max(total, off + rec.size)
            allocated.append(rec)
            allocated.sort(key=lambda r: (offsets[r.tensor_id], r.tensor_id))
    return OffsetAssignment("greedy_by_breadth", offsets, total)


def strip_packing_bestfit(records: Sequence[TensorUsageRecord]) -> OffsetAssignment:
    """Seed Sekiyama'18 strip packing (first-fit decreasing), full scan."""
    offsets: dict[int, int] = {}
    allocated: list[TensorUsageRecord] = []
    total = 0
    order = sorted(records, key=lambda r: (-r.size, r.first_op, r.tensor_id))
    for rec in order:
        prev_offset = 0
        placed_off: int | None = None
        for x in allocated:
            if rec.overlaps(x):
                x_off = offsets[x.tensor_id]
                if x_off - prev_offset >= rec.size:
                    placed_off = prev_offset
                    break
                prev_offset = max(prev_offset, x_off + x.size)
        if placed_off is None:
            placed_off = prev_offset
        offsets[rec.tensor_id] = placed_off
        total = max(total, placed_off + rec.size)
        allocated.append(rec)
        allocated.sort(key=lambda r: (offsets[r.tensor_id], r.tensor_id))
    return OffsetAssignment("strip_packing_bestfit", offsets, total)


def tflite_greedy_in_order_offsets(
    records: Sequence[TensorUsageRecord],
) -> OffsetAssignment:
    """Seed Lee'19 'Greedy' offsets: execution order + full-scan best-fit."""
    offsets: dict[int, int] = {}
    allocated: list[TensorUsageRecord] = []
    total = 0
    order = sorted(records, key=lambda r: (r.first_op, -r.size, r.tensor_id))
    for rec in order:
        off = _best_fit_offset(rec, allocated, offsets)
        offsets[rec.tensor_id] = off
        total = max(total, off + rec.size)
        allocated.append(rec)
        allocated.sort(key=lambda r: (offsets[r.tensor_id], r.tensor_id))
    return OffsetAssignment("tflite_greedy_in_order", offsets, total)


def greedy_by_conflict(records: Sequence[TensorUsageRecord]) -> SharedObjectsAssignment:
    """Seed beyond-paper strategy (core/extensions.py): pairwise conflict
    mass + the Greedy-by-Breadth ``is_better`` object scan."""
    records = list(records)
    conflict = {r.tensor_id: 0 for r in records}
    for i, a in enumerate(records):
        for b in records[i + 1:]:
            if a.overlaps(b):
                conflict[a.tensor_id] += b.size
                conflict[b.tensor_id] += a.size
    order = sorted(
        records,
        key=lambda r: (-(conflict[r.tensor_id] + r.size), -r.size, r.tensor_id),
    )
    asn = _new_assignment("greedy_by_conflict")
    for rec in order:
        best: _RefObject | None = None
        for obj in asn.objects:
            if not obj.fits(rec):
                continue
            if best is None:
                best = obj
            elif best.size < rec.size:
                if obj.size > best.size:
                    best = obj
            elif rec.size <= obj.size < best.size:
                best = obj
        if best is None:
            best = _create_object(asn, rec)
        best.assign(rec)
        asn.assignment[rec.tensor_id] = best.object_id
    return asn


REFERENCE_SHARED_OBJECT_STRATEGIES: dict[
    str, Callable[[Sequence[TensorUsageRecord]], SharedObjectsAssignment]
] = {
    "greedy_by_size": greedy_by_size,
    "greedy_by_size_improved": greedy_by_size_improved,
    "greedy_by_breadth": greedy_by_breadth,
    "greedy_by_conflict": greedy_by_conflict,
}

REFERENCE_OFFSET_STRATEGIES: dict[
    str, Callable[[Sequence[TensorUsageRecord]], OffsetAssignment]
] = {
    "greedy_by_size": greedy_by_size_offsets,
    "greedy_by_breadth": greedy_by_breadth_offsets,
    "strip_packing_bestfit": strip_packing_bestfit,
    "tflite_greedy_in_order": tflite_greedy_in_order_offsets,
}
