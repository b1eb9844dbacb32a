"""Tensor usage records, operator profiles and lower bounds (paper §3–§5.1).

The paper's vocabulary, verbatim:

* **Tensor usage interval** of intermediate tensor ``t``:
  ``{first_op_t, last_op_t}`` — indices of the first and last operator (in
  the fixed topological execution order) that use ``t`` as input or output.
* **Tensor usage record**: ``{first_op_t, last_op_t, size_t}`` with
  ``size_t`` the aligned size in bytes.
* **Operator profile** of operator ``op``: all records whose interval
  contains ``op``.
* **Operator breadth**: sum of tensor sizes in its profile.
* **i-th positional maximum**: max over operators of the i-th largest
  tensor size in each profile.

Lower bounds:
* Shared Objects LB = sum of positional maximums (paper §4.1).
* Offset Calculation LB = max operator breadth (paper §5.1).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

DEFAULT_ALIGNMENT = 64  # bytes; TFLite's default, matches the paper's tables


def align(size: int, alignment: int = DEFAULT_ALIGNMENT) -> int:
    """Round ``size`` up to a multiple of ``alignment``."""
    if alignment <= 0:
        raise ValueError(f"alignment must be positive, got {alignment}")
    return -(-size // alignment) * alignment


@dataclasses.dataclass(frozen=True, order=True)
class TensorUsageRecord:
    """One intermediate tensor's lifetime + aligned byte size.

    ``tensor_id`` identifies the tensor in the source graph. Ordering
    (via ``order=True``) is only used for deterministic tie-breaking.
    """

    first_op: int
    last_op: int
    size: int
    tensor_id: int = 0

    def __post_init__(self) -> None:
        if self.first_op < 0 or self.last_op < self.first_op:
            raise ValueError(
                f"invalid usage interval [{self.first_op}, {self.last_op}]"
            )
        if self.size <= 0:
            raise ValueError(f"tensor size must be positive, got {self.size}")

    def overlaps(self, other: "TensorUsageRecord") -> bool:
        """True iff the two usage intervals intersect (closed intervals)."""
        return max(self.first_op, other.first_op) <= min(
            self.last_op, other.last_op
        )


def records_overlap(a: TensorUsageRecord, b: TensorUsageRecord) -> bool:
    return a.overlaps(b)


def num_operators(records: Sequence[TensorUsageRecord]) -> int:
    return 0 if not records else 1 + max(r.last_op for r in records)


def operator_profiles(
    records: Sequence[TensorUsageRecord],
) -> list[list[TensorUsageRecord]]:
    """profiles[i] = all records live at operator i, sorted by size desc.

    Sorting in non-increasing size order is how the paper defines the
    profiles used for positional maximums (Fig. 2b).
    """
    n_ops = num_operators(records)
    profiles: list[list[TensorUsageRecord]] = [[] for _ in range(n_ops)]
    for r in records:
        for op in range(r.first_op, r.last_op + 1):
            profiles[op].append(r)
    for p in profiles:
        p.sort(key=lambda r: (-r.size, r.tensor_id))
    return profiles


def operator_breadths(records: Sequence[TensorUsageRecord]) -> list[int]:
    """breadths[i] = sum of live tensor sizes at operator i.

    Event sweep (difference array + prefix sum): O(n + n_ops) instead of
    walking every record's full interval.
    """
    n_ops = num_operators(records)
    delta = [0] * (n_ops + 1)
    for r in records:
        delta[r.first_op] += r.size
        delta[r.last_op + 1] -= r.size
    breadths = [0] * n_ops
    acc = 0
    for i in range(n_ops):
        acc += delta[i]
        breadths[i] = acc
    return breadths


def positional_maximums(records: Sequence[TensorUsageRecord]) -> list[int]:
    """pm[i] = max over operator profiles of the i-th largest live size."""
    profiles = operator_profiles(records)
    depth = max((len(p) for p in profiles), default=0)
    out = []
    for i in range(depth):
        out.append(max(p[i].size for p in profiles if len(p) > i))
    return out


def shared_objects_lower_bound(records: Sequence[TensorUsageRecord]) -> int:
    """Paper §4.1: sum of positional maximums."""
    return sum(positional_maximums(records))


def offsets_lower_bound(records: Sequence[TensorUsageRecord]) -> int:
    """Paper §5.1: maximum operator breadth."""
    return max(operator_breadths(records), default=0)


def naive_consumption(records: Sequence[TensorUsageRecord]) -> int:
    """The paper's 'Naive' baseline: every intermediate co-resident."""
    return sum(r.size for r in records)


def make_records(
    triples: Iterable[tuple[int, int, int]],
) -> list[TensorUsageRecord]:
    """Convenience: build records from (first_op, last_op, size) triples."""
    return [
        TensorUsageRecord(first_op=f, last_op=l, size=s, tensor_id=i)
        for i, (f, l, s) in enumerate(triples)
    ]
