"""Plan identity (copy of the part of the reference's ``core/plan_io.py``
the port uses).

``canonical_records`` is the reference's function, byte for byte
(``tests/test_torch_executor.py`` holds the copy to it): the executor's
precomputed-plan identity check compares record sets through it. Plan
JSON, the plan cache and bundles come with ROADMAP A12.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.core.records import TensorUsageRecord


def canonical_records(
    records: Sequence[TensorUsageRecord],
) -> list[tuple[int, int, int, int]]:
    """Producer-order-independent canonical form, shared by every content
    key over a record set: the plan-cache signature, the unified-plan
    spec fingerprint, and the executor's precompiled-plan identity check.
    """
    return sorted((r.tensor_id, r.first_op, r.last_op, r.size) for r in records)
