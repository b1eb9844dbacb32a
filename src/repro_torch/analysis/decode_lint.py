"""Lint of a live serving engine: the port's decode lint.

Counterpart of the reference's ``analysis/decode_lint.py``, whose checks
read the compiled decode HLO (``lint_program``: the state buffer's
donation aliases input to output, no host transfer inside the step, the
block is one rolled loop). A captured CUDA graph has no HLO to read, so
the same serving invariants are checked on the engine while it serves:

* ``host-sync-in-block`` — nothing synchronizes with the host while a
  block's waves are replayed: ``torch.cuda.set_sync_debug_mode("error")``
  is on around the replays and the copies of the block's outputs (on
  the card only; the CPU has nothing to synchronize);
* ``state-buffer-moved`` / ``arena-moved`` — the state buffer and the
  activation arena keep their ``data_ptr`` across the run: the graphs
  bake their addresses in, so a moved buffer would be read stale;
* ``capture-after-warmup`` — ``capture_calls`` does not move while
  serving: no capture per request or per block length.

:func:`lint_executables` (reference ``decode_lint.py:350-403``) audits a
bundle's AOT decode program after serialization, on the program itself
(the reference reads the loaded executable's HLO; the port's program is
an aten graph, device-independent, so the audit runs on the CPU too):

* ``executable-load-failed`` — the payload does not deserialize;
* ``executable-graph-mismatch`` — the loaded program's usage records are
  not the bundle's graph (its structural fingerprint differs), so the
  bundle's activation plan would not cover it;
* ``host-transfer`` — a node moves data to the host or synchronizes with
  it (``aten._local_scalar_dense``, ``aten.item``, ``nonzero`` …, or a
  ``device`` argument naming the CPU in a program traced on ``meta``);
* ``state-not-donated`` — the step's state outputs are not its state
  inputs written in place (the reference's donation aliasing): the step
  would allocate a whole new state each wave.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.analysis import counters
from repro_torch.analysis.findings import Finding

PASS = "decode_lint"


def _finding(code: str, message: str, where: str = "") -> Finding:
    return Finding(pass_name=PASS, code=code, message=message, where=where)


def lint_run(engine, run: Callable[[], Any], *, label: str = "") -> list[Finding]:
    """Call ``run()`` — serving on ``engine`` — under the three checks,
    and return what they found (empty when the run was clean). A host
    sync inside a block ends the run there and is reported."""
    where = label or engine.cfg.name
    # residency off: no state buffer and no arena to keep in place
    resident = engine.state.residency
    state_ptr = engine.state.buf.data_ptr() if resident else None
    arena_ptr = engine.activation_arena.buf.data_ptr() if resident else None
    captures = counters.read("capture_calls")
    findings: list[Finding] = []
    engine.state.sync_guard = True
    try:
        run()
    except RuntimeError as e:
        if "synchroniz" not in str(e):
            raise
        findings.append(_finding(
            "host-sync-in-block",
            f"a block's replayed waves synchronized with the host: {e}", where))
    finally:
        engine.state.sync_guard = False
    if resident and engine.state.buf.data_ptr() != state_ptr:
        findings.append(_finding(
            "state-buffer-moved",
            "the state buffer moved during the run; the captured graphs "
            "still address the old one", where))
    if resident and engine.activation_arena.buf.data_ptr() != arena_ptr:
        findings.append(_finding(
            "arena-moved",
            "the activation arena moved during the run; the captured "
            "graphs still address the old one", where))
    captured = counters.read("capture_calls") - captures
    if captured:
        findings.append(_finding(
            "capture-after-warmup",
            f"{captured} CUDA graph capture(s) while serving; every graph "
            f"is captured at construction", where))
    return findings


# aten ops that copy a value to the host or wait on the device for one
_HOST_OPS = frozenset({
    "_local_scalar_dense", "item", "nonzero", "is_nonzero", "equal",
    "masked_select", "_unique2", "unique_dim", "unique_consecutive",
})


def _host_transfers(gm) -> list[str]:
    import torch

    found = []
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        packet = getattr(node.target, "overloadpacket", None)
        if packet is not None and packet.__name__ in _HOST_OPS:
            found.append(f"{node.name} ({node.target})")
            continue
        devices = []
        torch.fx.node.map_aggregate(
            (node.args, node.kwargs),
            lambda a: devices.append(a) if isinstance(a, torch.device) else a)
        if any(d.type == "cpu" for d in devices):
            found.append(f"{node.name} ({node.target} to the CPU)")
    return found


def _state_not_in_place(trace) -> list[int]:
    """Flat positions of the step's state outputs that are not its state
    inputs (the fourth argument) written in place."""
    import torch.utils._pytree as pytree

    gm = trace.gm
    info = gm.graph._codegen.pytree_info
    places = [n for n in gm.graph.nodes if n.op == "placeholder"]
    (args, _kw) = pytree.tree_unflatten(list(range(len(places))), info.in_spec)
    state_in = [trace.node_tid.get(places[i]) for i in pytree.tree_leaves(args[3])]
    out = next(n for n in gm.graph.nodes if n.op == "output")
    flat = pytree.tree_leaves(out.args[0])
    _logits, state = pytree.tree_unflatten(list(range(len(flat))), info.out_spec)
    state_out = [trace.node_tid.get(flat[i]) for i in pytree.tree_leaves(state)]
    if len(state_out) != len(state_in):
        return list(range(len(state_out)))
    return [k for k, (o, i) in enumerate(zip(state_out, state_in)) if o != i]


def lint_executables(bundle) -> list[Finding]:
    """Audit a bundle's AOT decode program after serialization: it must
    load, be the bundle's graph, move nothing to the host, and write the
    state it reads in place. A reference pack (jax executables, carried
    opaque) is not the port's to load: none of its entries is audited
    here (``bundle_lint`` checks its key and its payloads)."""
    pack = getattr(bundle, "executables", None)
    if pack is None or not pack.is_port:
        return []
    from repro_torch.core.artifact import graph_fingerprint
    from repro_torch.runtime.aot import PROGRAM_DEVICE, deserialize_program

    findings: list[Finding] = []
    for name, entry in sorted(pack.entries.items()):
        label = f"{bundle.arch}:{name}"
        try:
            trace = deserialize_program(entry.payload, device=PROGRAM_DEVICE,
                                        name=label)
        except Exception as e:
            findings.append(_finding(
                "executable-load-failed",
                f"AOT executable failed to deserialize ({type(e).__name__}: "
                f"{e})", label))
            continue
        fresh = graph_fingerprint(trace.graph)
        if fresh != bundle.graph_fingerprint:
            findings.append(_finding(
                "executable-graph-mismatch",
                f"the loaded program's records are not the bundle's graph "
                f"(program {fresh[:12]}, bundle "
                f"{str(bundle.graph_fingerprint)[:12]}); the bundle's plan "
                f"does not cover it", label))
        host = _host_transfers(trace.gm)
        if host:
            findings.append(_finding(
                "host-transfer",
                f"{len(host)} node(s) of the decode step move data to the "
                f"host or wait for it: {', '.join(host[:3])}", label))
        fresh_state = _state_not_in_place(trace)
        if fresh_state:
            findings.append(_finding(
                "state-not-donated",
                f"{len(fresh_state)} state output(s) of the step are not its "
                f"state inputs written in place (flat state outputs "
                f"{fresh_state[:4]}): every step would allocate a new state",
                label))
    return findings
