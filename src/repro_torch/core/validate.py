"""Independent validity checkers for memory plans (used by every test).

These re-derive the constraints from first principles so a bug in a
strategy cannot hide behind a matching bug in its own bookkeeping. They
are deliberately naive — O(n²) pairwise sweeps — and stay that way: this
module is the SLOW ORACLE TWIN of the O(n log n) sweep-line certifier in
``repro_torch.analysis.soundness``, which is differential-tested against it
(same verdict on every corpus graph and every seeded mutation).

Violations raise :class:`PlanValidationError`, never a bare ``assert``:
``python -O`` strips assert statements, and a checker that silently
becomes a no-op under optimization is worse than no checker at all
(``scripts/ci.sh`` runs a ``python -O`` smoke pinning exactly this).
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.offsets import OffsetAssignment
from repro_torch.core.records import (
    TensorUsageRecord,
    naive_consumption,
    offsets_lower_bound,
    shared_objects_lower_bound,
)
from repro_torch.core.shared_objects import SharedObjectsAssignment


class PlanValidationError(AssertionError):
    """A memory plan violates one of the paper's soundness constraints.

    Subclasses ``AssertionError`` for backwards compatibility (these
    checks used to be bare asserts), but is raised explicitly so the
    checkers keep working under ``python -O``.
    """


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise PlanValidationError(msg)


def check_shared_objects(
    records: Sequence[TensorUsageRecord], asn: SharedObjectsAssignment
) -> None:
    by_id = {r.tensor_id: r for r in records}
    _require(
        set(asn.assignment) == set(by_id),
        f"{asn.strategy}: assignment covers {len(asn.assignment)} of "
        f"{len(by_id)} tensors",
    )
    # no two overlapping tensors share an object
    recs = list(records)
    for i, a in enumerate(recs):
        for b in recs[i + 1 :]:
            if a.overlaps(b):
                _require(
                    asn.assignment[a.tensor_id] != asn.assignment[b.tensor_id],
                    f"{asn.strategy}: tensors {a.tensor_id} and {b.tensor_id} "
                    f"overlap ({a} vs {b}) but share object "
                    f"{asn.assignment[a.tensor_id]}",
                )
    # object size == max assigned tensor size (no padding, no undersizing)
    sizes: dict[int, int] = {}
    for tid, oid in asn.assignment.items():
        sizes[oid] = max(sizes.get(oid, 0), by_id[tid].size)
    for obj in asn.objects:
        _require(
            obj.size == sizes.get(obj.object_id, obj.size),
            f"{asn.strategy}: object {obj.object_id} size {obj.size} != "
            f"max assigned {sizes.get(obj.object_id)}",
        )
        _require(
            obj.size >= sizes.get(obj.object_id, 0),
            f"{asn.strategy}: object {obj.object_id} undersized",
        )
    # bounds
    lb = shared_objects_lower_bound(records)
    naive = naive_consumption(records)
    _require(
        lb <= asn.total_size <= naive,
        f"{asn.strategy}: total {asn.total_size} outside [{lb}, {naive}]",
    )


def check_offsets(
    records: Sequence[TensorUsageRecord], asn: OffsetAssignment
) -> None:
    by_id = {r.tensor_id: r for r in records}
    _require(
        set(asn.offsets) == set(by_id),
        f"{asn.strategy}: offsets cover {len(asn.offsets)} of {len(by_id)}",
    )
    recs = list(records)
    for i, a in enumerate(recs):
        off_a = asn.offsets[a.tensor_id]
        _require(off_a >= 0, f"{asn.strategy}: tensor {a.tensor_id} offset < 0")
        _require(
            off_a + a.size <= asn.total_size,
            f"{asn.strategy}: tensor {a.tensor_id} spills past total",
        )
        for b in recs[i + 1 :]:
            if a.overlaps(b):
                off_b = asn.offsets[b.tensor_id]
                disjoint = off_a + a.size <= off_b or off_b + b.size <= off_a
                _require(
                    disjoint,
                    f"{asn.strategy}: overlapping-in-time tensors "
                    f"{a.tensor_id}@[{off_a},{off_a + a.size}) and "
                    f"{b.tensor_id}@[{off_b},{off_b + b.size}) collide in memory",
                )
    lb = offsets_lower_bound(records)
    naive = naive_consumption(records)
    _require(
        lb <= asn.total_size <= naive,
        f"{asn.strategy}: total {asn.total_size} outside [{lb}, {naive}]",
    )
