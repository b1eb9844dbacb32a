"""A minimal tensor-program IR: operators × tensors → usage records.

Copy of the reference's ``core/graph.py`` (the part the port's planner
consumes). The port's producer is the fx tracer
(``trace/fx_liveness.py``).

A ``Graph`` is a list of ``Op``s in a fixed topological execution order
(the paper assumes the order is fixed). Tensors are identified by integer
ids; each has a byte size.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.records import DEFAULT_ALIGNMENT, TensorUsageRecord, align


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor in the graph. Size is bytes *before* alignment."""

    tensor_id: int
    nbytes: int
    name: str = ""
    shape: tuple[int, ...] | None = None
    dtype: str | None = None


@dataclasses.dataclass(frozen=True)
class Op:
    """One operator: consumes ``inputs`` tensor ids, produces ``outputs``."""

    name: str
    inputs: tuple[int, ...]
    outputs: tuple[int, ...]


@dataclasses.dataclass
class Graph:
    """Operator list in execution order + tensor table.

    ``boundary_ids`` are tensors that are NOT intermediates (graph inputs,
    weights, final outputs — the paper's Fig. 1 excludes tensor #8, the
    output). They never receive usage records.
    """

    name: str
    ops: list[Op]
    tensors: dict[int, TensorSpec]
    boundary_ids: frozenset[int] = frozenset()

    def intermediate_ids(self) -> list[int]:
        used: set[int] = set()
        for op in self.ops:
            used.update(op.inputs)
            used.update(op.outputs)
        return sorted(t for t in used if t not in self.boundary_ids)

    def usage_records(
        self, alignment: int = DEFAULT_ALIGNMENT
    ) -> list[TensorUsageRecord]:
        """Extract the paper's tensor usage records (§3)."""
        first: dict[int, int] = {}
        last: dict[int, int] = {}
        for op_idx, op in enumerate(self.ops):
            for t in (*op.inputs, *op.outputs):
                if t not in first:
                    first[t] = op_idx
                last[t] = op_idx
        records = []
        for t in self.intermediate_ids():
            if t not in first:
                continue  # unused tensor — no memory needed
            records.append(
                TensorUsageRecord(
                    first_op=first[t],
                    last_op=last[t],
                    size=align(self.tensors[t].nbytes, alignment),
                    tensor_id=t,
                )
            )
        return records

    def validate(self) -> None:
        """Topological-order sanity: every input is produced earlier (or is
        a boundary tensor), every tensor has a spec, no double-produce."""
        produced: set[int] = set()
        for op_idx, op in enumerate(self.ops):
            for t in op.inputs:
                if t not in self.tensors:
                    raise ValueError(f"{self.name}: op {op_idx} input {t} has no spec")
                if t not in produced and t not in self.boundary_ids:
                    raise ValueError(
                        f"{self.name}: op {op_idx} ({op.name}) reads tensor {t} "
                        "before it is produced"
                    )
            for t in op.outputs:
                if t not in self.tensors:
                    raise ValueError(f"{self.name}: op {op_idx} output {t} has no spec")
                if t in produced:
                    raise ValueError(f"{self.name}: tensor {t} produced twice")
                produced.add(t)
