"""Cost of one traced per-device program: FLOPs, bytes and collectives.

Counterpart of the reference's ``launch/hlo_analysis.py``, named after
it as ``trace/fx_liveness.py`` is named after ``jaxpr_liveness.py``. The
reference parses the compiled HLO text of the sharded step; the port
counts over the aten-level fx graph that ``make_fx`` traces out of a
step on DTensors (``launch/dryrun.py``), which is one rank's local
program with its collectives as ``_c10d_functional`` nodes.

``analyze(gm) -> GraphCost``:

* flops: ``torch.utils.flop_counter``'s registry applied to each node's
  ``meta["val"]`` shapes (2·M·N·K for a product), and for the port's
  custom ops the formulas of ``launch/roofline.py`` (``flash_decode`` and
  ``flash_decode_lse``, ``ssd_chunk`` and its backward);
* bytes: the inputs plus the outputs of every node that makes new memory
  (a view, an alias, ``getitem`` and ``wait_tensor`` move nothing);
* collective bytes by kind and counts over the ``_c10d_functional``
  ops, in the reference's convention: the OPERAND bytes of all-gather,
  all-reduce, reduce-scatter and all-to-all (``hlo_analysis.py:22-23``);
  ``wait_tensor`` is not a collective.

There is no trip counting: a Python loop unrolls in an fx trace, so an
n-layer stack is n copies of its layer in the graph, where the
reference's ``lax.scan`` is one ``while`` body it multiplies by its trip
count.
"""

from __future__ import annotations

import dataclasses
import operator

import torch
import torch.utils._pytree as pytree
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import roofline
from repro_torch.trace.fx_liveness import _nbytes, _returns_alias

# _c10d_functional op name -> the reference's collective kind
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


@dataclasses.dataclass
class GraphCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_bytes_by_kind: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)


def _val(a):
    return a.meta.get("val") if isinstance(a, torch.fx.Node) else a


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _collective(node: torch.fx.Node) -> str | None:
    ns = getattr(node.target, "namespace", None)
    if ns != "_c10d_functional":
        return None
    return COLLECTIVES.get(node.target._opname)


def _custom_flops(node: torch.fx.Node, args) -> int | None:
    packet = getattr(node.target, "overloadpacket", None)
    if packet in (torch.ops.repro_torch.flash_decode,
                  torch.ops.repro_torch.flash_decode_lse):
        return roofline.flash_decode_flops(tuple(args[0].shape), tuple(args[1].shape))
    if packet is torch.ops.repro_torch.ssd_chunk:
        return roofline.ssd_chunk_flops(tuple(args[0].shape), tuple(args[5].shape))
    if packet is torch.ops.repro_torch.ssd_chunk_bwd:
        return roofline.ssd_chunk_bwd_flops(tuple(args[0].shape), tuple(args[5].shape))
    return None


def node_flops(node: torch.fx.Node) -> int:
    """FLOPs of one ``call_function`` node (0 for an op with no formula)."""
    args, kwargs = pytree.tree_map(_val, (node.args, node.kwargs))
    n = _custom_flops(node, args)
    if n is not None:
        return n
    formula = flop_registry.get(getattr(node.target, "overloadpacket", None))
    if formula is None:
        return 0
    return int(formula(*args, out_val=node.meta.get("val"), **kwargs))


def _moves_nothing(node: torch.fx.Node) -> bool:
    if node.target is operator.getitem or _returns_alias(node):
        return True
    return getattr(node.target, "namespace", None) == "_c10d_functional" and \
        node.target._opname == "wait_tensor"


def analyze(gm: torch.fx.GraphModule) -> GraphCost:
    """Count FLOPs, bytes and collectives over ``gm``'s nodes (a traced
    program whose nodes carry ``meta["val"]``)."""
    cost = GraphCost()
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        kind = _collective(node)
        if kind is not None:
            operand = sum(_nbytes(t) for t in _tensors(_val(node.args[0])))
            cost.collective_bytes += operand
            cost.collective_bytes_by_kind[kind] = (
                cost.collective_bytes_by_kind.get(kind, 0) + operand)
            cost.collective_counts[kind] = cost.collective_counts.get(kind, 0) + 1
            continue
        if _moves_nothing(node):
            continue
        cost.flops += node_flops(node)
        ins = {id(t): t for a in node.all_input_nodes for t in _tensors(_val(a))}
        cost.bytes += sum(_nbytes(t) for t in ins.values())
        cost.bytes += sum(_nbytes(t) for t in _tensors(node.meta.get("val")))
    return cost
