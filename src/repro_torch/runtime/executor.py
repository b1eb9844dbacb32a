"""Arena-backed fx interpreter: runs a function with the planned reuse.

Port of the reference's ``runtime/executor.py``. The Offset Calculation
deployment path (paper §5) executed for real: every intermediate a node
produces lives in ONE flat arena at its planned offset, and tensors
whose usage intervals have ended are overwritten by later tensors that
share their bytes. If the plan were wrong the results would be garbage,
so agreement with eager execution is an end-to-end proof of plan
validity.

The function is traced once (``trace/fx_liveness.trace_fx``) and its
aten-level fx graph is walked on every call:

* a node that returns an alias (a view, or an in-place op, per the
  tracer) runs as it is: it writes or views memory that already has a
  place;
* a node that produces a new tensor runs through its ``out=`` overload
  (``aten.X.out``, ``.Tensor_out``, ``.Scalar_out`` …, resolved once at
  construction from the op's schema) straight into its arena view, which
  has the traced value's shape and strides;
* a node with no such overload — the custom ops
  ``repro_torch::flash_decode`` and ``repro_torch::ssd_chunk`` among
  them — runs, and its result is ``copy_``'d into its slot (the
  reference's ``arena.store``);
* a node whose result is a boundary tensor (a graph output) runs as it
  is and keeps its own memory, as the reference keeps boundary values
  out of the arena.

Nothing gives way to eager execution: a node that cannot be placed
raises at construction, naming the op. The arena views are built once,
so the arena never moves, and under a CUDA graph capture
(``runtime/graphs.py``) every intermediate has a fixed, planned address.
"""

from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from repro_torch.core import plan_io
from repro_torch.core.planner import MemoryPlan, plan_graph
from repro_torch.runtime.arena import Arena, ArenaLayout
from repro_torch.runtime.device import resolve_device
from repro_torch.trace.fx_liveness import FxTrace, trace_fx

# tensor options an out= overload takes from its out tensor instead
_OPTIONS = frozenset({"dtype", "layout", "device", "pin_memory"})


@dataclasses.dataclass
class ExecutionStats:
    arena_bytes: int
    naive_peak_bytes: int  # sum of all intermediate tensors (paper's Naive)
    n_ops: int
    # producing nodes, by how their result reaches memory: written by an
    # out= overload into its slot, copied into its slot after the op, or
    # left out of the arena (a boundary tensor)
    n_in_place: int = 0
    n_copied: int = 0
    n_boundary: int = 0
    # bytes the copied nodes copy into the arena per call
    copied_bytes: int = 0

    @property
    def reduction(self) -> float:
        return self.naive_peak_bytes / max(self.arena_bytes, 1)


class _Ref:
    """A node's value in the environment, by position."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _load(template: Any, env: list) -> Any:
    if isinstance(template, _Ref):
        return env[template.i]
    if isinstance(template, (list, tuple)):
        return type(template)(_load(t, env) for t in template)
    if isinstance(template, dict):
        return {k: _load(v, env) for k, v in template.items()}
    return template


@functools.lru_cache(maxsize=None)
def out_overload(op: torch._ops.OpOverload):
    """The ``out=`` overload computing ``op`` into given tensors, as
    ``(overload, names of its out arguments, names of op's kwargs it does
    not take)``; ``None`` when the op has none. An overload matches when
    its other arguments are ``op``'s, name and type, once the tensor
    options that the out tensor carries are left out."""
    schema = op._schema
    packet = op.overloadpacket
    want = [(a.name, str(a.type)) for a in schema.arguments]
    for name in packet.overloads():
        cand = getattr(packet, name)
        args = cand._schema.arguments
        outs = [a.name for a in args if a.is_out]
        if not outs or len(outs) != len(schema.returns):
            continue
        ins = [(a.name, str(a.type)) for a in args if not a.is_out]
        taken = {n for n, _ in ins}
        dropped = {n for n, _ in want if n not in taken}
        if dropped <= _OPTIONS and [w for w in want if w[0] not in dropped] == ins:
            return cand, tuple(outs), frozenset(dropped)
    return None


@dataclasses.dataclass
class _Step:
    kind: str  # "alias" | "out" | "copy" | "boundary" | "getitem"
    fn: Callable
    args: Any
    kwargs: Any
    # arena views the results go to ("out": one per out argument; "copy":
    # one per result, None for a boundary result)
    views: tuple = ()
    out_names: tuple = ()


class ArenaExecutor:
    """plan once → allocate once → run many (the paper's deployment mode).

    ``fn(*example_args)`` is traced on fake tensors; the example tensors
    are read for their metadata only, and later calls must pass tensors
    of the same shapes, dtypes and strides (the caches as views with the
    same strides). ``trace`` is a trace of ``fn`` on those arguments
    already made (``trace_fx``), taken as the program instead of tracing
    again. ``plan`` is a precomputed :class:`MemoryPlan` of this graph's
    records, refused if it covers other records. The arena lies on
    ``device`` (default: the device of the first example tensor, and
    without one the card: ``resolve_device`` raises if there is none)."""

    def __init__(
        self,
        fn: Callable,
        *example_args,
        strategy: str = "auto",
        alignment: int = 64,
        plan: MemoryPlan | None = None,
        device=None,
        name: str | None = None,
        trace: FxTrace | None = None,
    ):
        self.trace: FxTrace = (trace if trace is not None
                               else trace_fx(fn, *example_args, name=name))
        self.graph = self.trace.graph
        if plan is not None:
            # a precomputed plan skips the planner — but only if it covers
            # exactly this graph's records; a stale plan here would mean
            # silent memory corruption
            canon = plan_io.canonical_records
            if canon(plan.records) != canon(self.graph.usage_records(alignment)):
                raise ValueError(
                    "precomputed plan does not match this graph's usage "
                    "records; plan the graph again"
                )
            self.plan = plan
        else:
            self.plan = plan_graph(self.graph, mode="offsets", strategy=strategy,
                                   alignment=alignment)
        if device is None:
            leaves = [x for x in pytree.tree_leaves(example_args)
                      if isinstance(x, torch.Tensor)]
            device = leaves[0].device if leaves else None
        self.device = resolve_device(device)
        self.arena = Arena(ArenaLayout.from_plan(self.plan), self.device)
        self.stats = ExecutionStats(
            arena_bytes=self.plan.total_size,
            naive_peak_bytes=self.plan.naive_size,
            n_ops=len(self.graph.ops),
        )
        self._compile()

    # ---------------------------------------------------------- compile
    def _slot(self, node, tid: int, val: torch.Tensor) -> torch.Tensor:
        here = self.device
        if val.device.type != here.type or (
            None not in (val.device.index, here.index) and val.device.index != here.index
        ):
            raise ValueError(
                f"{node.target}: cannot place a {val.device} result in an "
                f"arena on {self.device}"
            )
        return self.arena.strided_view(tid, val.shape, val.stride(), val.dtype)

    def _compile(self) -> None:
        gm, tr = self.trace.gm, self.trace
        boundary = self.graph.boundary_ids
        index: dict[torch.fx.Node, int] = {}
        self._placeholders: list[int] = []
        self._steps: list[tuple[int, _Step]] = []
        self._consts: dict[int, torch.Tensor] = {}
        output = None
        for node in gm.graph.nodes:
            i = index[node] = len(index)
            if node.op == "placeholder":
                self._placeholders.append(i)
                continue
            if node.op == "output":
                output = node
                continue
            if node.op == "get_attr":
                val = getattr(gm, node.target)
                if isinstance(val, torch._subclasses.FakeTensor):
                    raise ValueError(f"constant {node.target} was traced as fake")
                self._consts[i] = val.to(self.device) if isinstance(val, torch.Tensor) else val
                continue
            if node.op != "call_function":
                raise ValueError(f"node {node.name}: {node.op} cannot be executed")
            args = torch.fx.node.map_arg(node.args, lambda n: _Ref(index[n]))
            kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: _Ref(index[n]))
            if node.target is operator.getitem:
                self._steps.append((i, _Step("getitem", operator.getitem, args, kwargs)))
                continue
            if not isinstance(node.target, torch._ops.OpOverload):
                raise ValueError(
                    f"node {node.name}: {node.target} is not an aten or custom "
                    f"op and cannot be placed in the arena"
                )
            tids = tr.produced.get(node)
            if tids is None:  # an alias or a result with no tensor
                self._steps.append((i, _Step("alias", node.target, args, kwargs)))
                continue
            val = node.meta["val"]
            vals = tuple(v for v in (val if isinstance(val, (tuple, list)) else (val,))
                         if isinstance(v, torch.Tensor))
            in_arena = [t not in boundary for t in tids]
            if not any(in_arena):
                self.stats.n_boundary += 1
                self._steps.append((i, _Step("boundary", node.target, args, kwargs)))
                continue
            views = tuple(self._slot(node, t, v) if keep else None
                          for t, v, keep in zip(tids, vals, in_arena))
            resolved = out_overload(node.target) if all(in_arena) else None
            if resolved is not None and len(resolved[1]) == len(views):
                fn, names, dropped = resolved
                kwargs = {k: v for k, v in kwargs.items() if k not in dropped}
                self.stats.n_in_place += 1
                self._steps.append((i, _Step("out", fn, args, kwargs, views, names)))
            else:
                self.stats.n_copied += 1
                self.stats.copied_bytes += sum(
                    v.numel() * v.element_size() for v in views if v is not None)
                self._steps.append((i, _Step("copy", node.target, args, kwargs, views)))
        self._n_env = len(index)
        self._out = torch.fx.node.map_arg(output.args[0], lambda n: _Ref(index[n]))
        codegen = gm.graph._codegen
        self._out_spec = getattr(getattr(codegen, "pytree_info", None), "out_spec", None)

    # ------------------------------------------------------------- run
    def __call__(self, *args):
        leaves = pytree.tree_leaves(args)
        if len(leaves) != len(self._placeholders):
            raise ValueError(
                f"expected {len(self._placeholders)} flat args, got {len(leaves)}"
            )
        env: list = [None] * self._n_env
        for i, val in zip(self._placeholders, leaves):
            env[i] = val
        for i, val in self._consts.items():
            env[i] = val
        with torch.no_grad():
            for i, st in self._steps:
                a = _load(st.args, env)
                kw = _load(st.kwargs, env)
                if st.kind == "out":
                    for name, view in zip(st.out_names, st.views):
                        kw[name] = view
                    st.fn(*a, **kw)
                    env[i] = st.views[0] if len(st.views) == 1 else st.views
                elif st.kind == "copy":
                    res = st.fn(*a, **kw)
                    outs = res if isinstance(res, (tuple, list)) else (res,)
                    placed = tuple(
                        o if v is None else v.copy_(o) for o, v in zip(outs, st.views))
                    env[i] = placed if isinstance(res, (tuple, list)) else placed[0]
                else:  # alias, boundary, getitem
                    env[i] = st.fn(*a, **kw)
        flat = _load(self._out, env)
        if self._out_spec is None:
            return flat
        return pytree.tree_unflatten(list(flat), self._out_spec)
