"""Extract the paper's tensor usage records from a PyTorch function.

Twin of the reference's ``trace/jaxpr_liveness.py``. ``trace_graph(fn,
*args)`` traces ``fn`` with ``make_fx(..., tracing_mode="fake")`` — fake
tensors carry shapes and dtypes, so nothing is computed and no device
memory is allocated — and converts the aten-level fx graph into a
:class:`repro_torch.core.graph.Graph`:

* each ``call_function`` node, in program order, becomes one operator;
* each tensor a node produces becomes a tensor whose byte size comes
  from ``node.meta["val"]`` (shape × dtype);
* placeholders (params, tokens, caches, positions, the active mask) and
  the graph's outputs are *boundary* tensors — the paper's carve-out.

Aliasing is where this differs from a jaxpr: an aten view (``view``,
``transpose``, ``select`` …) or in-place op (``index_put_``, ``mul_`` …)
returns the memory of its first argument rather than new memory. Such a
node is an operator that reads its inputs and produces no tensor, and
its output stands for the aliased tensor, whose lifetime it extends.
Custom ops trace as ONE node through their fake implementation (the
attention kernel is one operator, as a ``pallas_call`` is one jaxpr
equation).

A tensor is sized by its extent under its traced strides (the bytes an
``as_strided`` view of it spans), which is ``prod(shape) × itemsize``
for every dense layout, permuted ones included. A value with gaps
between its elements would need more; no node of the ported decode
steps or prefills produces one (``tests/test_torch_executor.py``).

``trace_fx`` keeps what the arena executor (``runtime/executor.py``)
needs beside the Graph: the ``GraphModule``, the fx node → tensor-id
map, and the tensors each producing node creates (the counterpart of the
reference's ``graph.var_tid``). ``trace_from_graph_module`` builds the
same from a program already made (``runtime/aot.py`` loads one).
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Callable

import torch
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.core.graph import Graph, Op, TensorSpec

# Instrumentation: total graph extractions this process. Tests snapshot
# it around engine construction (one trace per engine).
TRACE_CALLS = 0

# aten ops that return a view of their input without alias annotations,
# and the wait on a collective, whose result is the collective's output
# tensor itself (the collective's node is the one that makes it)
_UNANNOTATED_VIEWS = {"aten::_unsafe_view", "aten::_reshape_alias",
                      "_c10d_functional::wait_tensor"}


def _returns_alias(node: torch.fx.Node) -> bool:
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return False
    if schema.name in _UNANNOTATED_VIEWS:
        return True
    return any(r.alias_info is not None for r in schema.returns)


def extent(val: torch.Tensor) -> int:
    """Elements an ``as_strided`` view of ``val``'s shape and strides
    spans from its first element to its last (0 when empty)."""
    if val.numel() == 0:
        return 0
    return 1 + sum((n - 1) * s for n, s in zip(val.shape, val.stride()))


def _nbytes(val: torch.Tensor) -> int:
    return max(max(math.prod(val.shape), extent(val)) * val.element_size(), 1)


class _Builder:
    def __init__(self) -> None:
        self.tensors: dict[int, TensorSpec] = {}
        self.ops: list[Op] = []
        self.boundary: set[int] = set()
        # fx node -> tensor id, or a tuple of ids for multi-output nodes
        self.node_tid: dict[torch.fx.Node, Any] = {}
        # producing node -> the ids of the tensors it creates
        self.produced: dict[torch.fx.Node, tuple[int, ...]] = {}

    def new_tensor(self, val: torch.Tensor, name: str) -> int:
        tid = len(self.tensors)
        self.tensors[tid] = TensorSpec(
            tensor_id=tid,
            nbytes=_nbytes(val),
            name=name,
            shape=tuple(int(s) for s in val.shape),
            dtype=str(val.dtype).removeprefix("torch."),
        )
        return tid

    def inputs_of(self, node: torch.fx.Node) -> list[int]:
        ids: list[int] = []

        def visit(a: Any) -> None:
            if isinstance(a, torch.fx.Node):
                t = self.node_tid.get(a)
                if isinstance(t, int):
                    ids.append(t)
                elif isinstance(t, tuple):
                    ids.extend(t)

        torch.fx.node.map_arg((node.args, node.kwargs), visit)
        return list(dict.fromkeys(ids))

    def add(self, node: torch.fx.Node) -> None:
        val = node.meta.get("val")
        ins = self.inputs_of(node)
        if node.op == "placeholder":
            if isinstance(val, torch.Tensor):
                self.node_tid[node] = self.new_tensor(val, node.name)
                self.boundary.add(self.node_tid[node])
            return
        if node.op == "get_attr":  # a constant: not an intermediate
            if isinstance(val, torch.Tensor):
                self.node_tid[node] = self.new_tensor(val, node.name)
                self.boundary.add(self.node_tid[node])
            return
        if node.op != "call_function":
            return
        name = str(node.target)
        if node.target is operator.getitem:
            # selects one output of a multi-output node: an alias
            src, idx = node.args
            tids = self.node_tid.get(src)
            if isinstance(tids, tuple):
                self.node_tid[node] = tids[idx]
            self.ops.append(Op(name=name, inputs=tuple(ins), outputs=()))
            return
        first = node.args[0] if node.args else None
        if (
            _returns_alias(node)
            and isinstance(first, torch.fx.Node)
            and isinstance(self.node_tid.get(first), int)
        ):
            base = self.node_tid[first]
            # a list of views (split, unbind) aliases the base in every item
            self.node_tid[node] = (
                (base,) * len(val) if isinstance(val, (tuple, list)) else base
            )
            self.ops.append(Op(name=name, inputs=tuple(ins), outputs=()))
            return
        if isinstance(val, torch.Tensor):
            out = self.new_tensor(val, node.name)
            self.node_tid[node] = out
            outs: tuple[int, ...] = (out,)
        elif isinstance(val, (tuple, list)):
            outs = tuple(
                self.new_tensor(v, f"{node.name}.{i}")
                for i, v in enumerate(val)
                if isinstance(v, torch.Tensor)
            )
            self.node_tid[node] = outs
        else:  # no tensor result (e.g. a size)
            outs = ()
        if outs:
            self.produced[node] = outs
        self.ops.append(Op(name=name, inputs=tuple(ins), outputs=outs))


@dataclasses.dataclass
class FxTrace:
    """One trace: the fx program, its usage-record Graph, and the map
    between the two."""

    gm: torch.fx.GraphModule
    graph: Graph
    # fx node -> tensor id (or a tuple of ids for multi-output nodes)
    node_tid: dict[torch.fx.Node, Any]
    # nodes that create tensors -> the ids of those tensors, in the order
    # of the node's results
    produced: dict[torch.fx.Node, tuple[int, ...]]


def trace_fx(fn: Callable, *args, name: str | None = None) -> FxTrace:
    """Trace ``fn(*args)`` (pytrees of tensors allowed) on fake tensors
    into an aten-level fx program and its usage-record Graph. Real input
    tensors are only read for their metadata."""
    global TRACE_CALLS
    with torch.no_grad():
        gm = make_fx(fn, tracing_mode="fake")(*args)
    TRACE_CALLS += 1
    return trace_from_graph_module(gm, name=name or getattr(fn, "__name__", "fn"))


def trace_from_graph_module(gm: torch.fx.GraphModule, *, name: str) -> FxTrace:
    """The :class:`FxTrace` of an aten-level program already made, whose
    nodes carry ``meta["val"]`` (a ``make_fx`` trace, or a program loaded
    by ``runtime/aot.py``). Nothing is traced: ``TRACE_CALLS`` stays."""
    b = _Builder()
    output = None
    for node in gm.graph.nodes:
        if node.op == "output":
            output = node
            continue
        b.add(node)
    if output is not None:
        for t in b.inputs_of(output):
            b.boundary.add(t)
    g = Graph(name=name, ops=b.ops, tensors=b.tensors,
              boundary_ids=frozenset(b.boundary))
    g.validate()
    return FxTrace(gm=gm, graph=g, node_tid=b.node_tid, produced=b.produced)


def trace_graph(fn: Callable, *args, name: str | None = None) -> Graph:
    """Trace ``fn(*args)`` on fake tensors and return its Graph."""
    return trace_fx(fn, *args, name=name).graph
