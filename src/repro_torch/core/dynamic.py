"""Dynamic tensor sizes — the paper's §7 protocol, implemented.

    "For such cases, the algorithms need to be run multiple times saving
    information about allocation from all runs in one place. The first run
    will allocate only those tensors whose sizes are known at the
    beginning, and the second run will allocate those tensors whose sizes
    become known after calculation of the first dynamic tensor, etc."

``IncrementalPlanner`` keeps one shared arena across planning *stages*:
stage 0 plans the statically-known records; each later ``extend()`` call
plans newly-known records with every earlier placement FIXED, using the
same best-fit-gap rule as Greedy-by-Size (records within a stage are
taken size-descending). The arena only ever grows; earlier offsets are
never moved (an inference engine cannot relocate live buffers).

Typical use (RNN / dynamic-length decoding): ``extend()`` once per shape
resolution point, then materialize a single ``Arena`` of ``total_size``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.interval_set import BestFitArena
from repro_torch.core.offsets import OffsetAssignment
from repro_torch.core.records import TensorUsageRecord, naive_consumption


@dataclasses.dataclass
class IncrementalPlanner:
    _arena: BestFitArena = dataclasses.field(default_factory=BestFitArena)
    _allocated: list[TensorUsageRecord] = dataclasses.field(default_factory=list)
    n_stages: int = 0

    @property
    def offsets(self) -> dict[int, int]:
        return self._arena.offsets

    @property
    def total_size(self) -> int:
        return self._arena.total

    def extend(self, records: Sequence[TensorUsageRecord]) -> None:
        """Plan a newly-known batch of records against the fixed layout."""
        self.n_stages += 1
        order = sorted(records, key=lambda r: (-r.size, r.first_op, r.tensor_id))
        for rec in order:
            if rec.tensor_id in self._arena.offsets:
                raise ValueError(f"tensor {rec.tensor_id} already planned")
            self._arena.place(rec)
            self._allocated.append(rec)

    def as_assignment(self) -> OffsetAssignment:
        return OffsetAssignment(
            f"incremental[{self.n_stages} stages]",
            dict(self.offsets),
            self.total_size,
        )

    @property
    def records(self) -> list[TensorUsageRecord]:
        return list(self._allocated)

    def overhead_vs_oneshot(self) -> float:
        """How much the staging cost vs planning everything at once."""
        from repro_torch.core.offsets import greedy_by_size_offsets

        oneshot = greedy_by_size_offsets(self._allocated).total_size
        return self.total_size / max(oneshot, 1)
