"""A minimal tensor-program IR: operators × tensors → usage records.

This is the substrate the planner consumes. Two producers exist:
* hand-built graphs (the paper's six conv nets, ``models/convnets.py``)
* traced PyTorch programs (``trace/fx_liveness.py``)

A ``Graph`` is a list of ``Op``s in a fixed topological execution order (the
paper assumes the order is fixed; ``core/order_search.py`` explores
re-ordering as the paper's §7.1 future work). Tensors are identified by
integer ids; each has a byte size (or a shape+dtype from which the aligned
size is derived).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.records import DEFAULT_ALIGNMENT, TensorUsageRecord, align


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor in the graph. Size is bytes *before* alignment."""

    tensor_id: int
    nbytes: int
    name: str = ""
    shape: tuple[int, ...] | None = None
    dtype: str | None = None

    @staticmethod
    def from_shape(
        tensor_id: int,
        shape: Sequence[int],
        dtype: str = "float32",
        name: str = "",
    ) -> "TensorSpec":
        nbytes = int(math.prod(shape)) * np.dtype(dtype).itemsize
        return TensorSpec(
            tensor_id=tensor_id,
            nbytes=nbytes,
            name=name,
            shape=tuple(int(s) for s in shape),
            dtype=dtype,
        )


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


class GraphBuilder:
    """Imperative helper for constructing ``Graph``s (used by convnets)."""

    def __init__(self, name: str, dtype: str = "float32"):
        self.name = name
        self.dtype = dtype
        self._ops: list[Op] = []
        self._tensors: dict[int, TensorSpec] = {}
        self._boundary: set[int] = set()
        self._next_id = 0

    def tensor(self, shape: Sequence[int], name: str = "", dtype: str | None = None) -> int:
        tid = self._next_id
        self._next_id += 1
        self._tensors[tid] = TensorSpec.from_shape(
            tid, shape, dtype or self.dtype, name
        )
        return tid

    def input(self, shape: Sequence[int], name: str = "input") -> int:
        tid = self.tensor(shape, name)
        self._boundary.add(tid)
        return tid

    def mark_output(self, tensor_id: int) -> None:
        self._boundary.add(tensor_id)

    def op(
        self,
        name: str,
        inputs: Sequence[int],
        out_shape: Sequence[int],
        out_name: str = "",
    ) -> int:
        """Add an op producing one new tensor; returns its id."""
        out = self.tensor(out_shape, out_name or name)
        self._ops.append(Op(name=name, inputs=tuple(inputs), outputs=(out,)))
        return out

    def raw_op(self, name: str, inputs: Sequence[int], outputs: Sequence[int]) -> None:
        self._ops.append(Op(name=name, inputs=tuple(inputs), outputs=tuple(outputs)))

    def build(self) -> Graph:
        g = Graph(
            name=self.name,
            ops=list(self._ops),
            tensors=dict(self._tensors),
            boundary_ids=frozenset(self._boundary),
        )
        g.validate()
        return g


def graph_from_records(
    records: Iterable[TensorUsageRecord], name: str = "synthetic"
) -> Graph:
    """Build a degenerate Graph whose usage records equal ``records``.

    Used by property tests: the planner algorithms only ever look at
    records, so a record-level generator covers them fully.
    """
    records = list(records)
    n_ops = 0 if not records else 1 + max(r.last_op for r in records)
    produces: dict[int, list[int]] = {i: [] for i in range(n_ops)}
    consumes: dict[int, list[int]] = {i: [] for i in range(n_ops)}
    tensors = {}
    for r in records:
        tensors[r.tensor_id] = TensorSpec(tensor_id=r.tensor_id, nbytes=r.size)
        produces[r.first_op].append(r.tensor_id)
        if r.last_op != r.first_op:
            consumes[r.last_op].append(r.tensor_id)
    ops = [
        Op(name=f"op{i}", inputs=tuple(consumes[i]), outputs=tuple(produces[i]))
        for i in range(n_ops)
    ]
    return Graph(name=name, ops=ops, tensors=tensors)
