"""AOT decode programs: trace at publish time, serve with ZERO traces.

Twin of the reference's ``runtime/aot.py``. The reference compiles its
decode jits offline and ships the XLA executables in the plan bundle, so
a bundle-served engine compiles nothing. The port's counterpart of a
compiled executable is the arena executor's program: the aten-level fx
graph of the decode step (``trace/fx_liveness.trace_fx``), with every
node's value metadata. This module ships that program:

* :func:`build_decode_executables` traces the bucket's decode program on
  ``meta`` through ``runtime/engine.decode_program`` (the program the
  engine serves, so the packed graph IS the graph the engine would
  trace), exports the traced ``GraphModule`` with ``torch.export`` and
  saves it to bytes WITHOUT its example inputs (the params are inputs:
  with them a full-width pack would carry the weights). It exports the
  ``make_fx`` graph, not the step function: an export of the function
  records another graph (``aten.matmul`` where the trace has ``mm``, and
  metadata asserts), whose records would not be the bundle's plan;
* :func:`load_executables` is the serving side, all or nothing: a pack
  another runtime wrote (the reference's), another torch version, a
  payload whose sha256 does not match, a load error, or a program whose
  records' structural fingerprint is not the bundle's ``graph_fingerprint``
  refuses the WHOLE pack with a one-line reason, and the engine warns
  once and traces its step as without a pack. A loaded program is
  retargeted from ``meta`` to the engine's device: every node's
  ``meta["val"]`` and every ``device`` argument (``aten.arange`` takes
  one).

The pack has ONE entry (:func:`expected_executable_entries`):
``resident_decode``, or ``paged_decode`` under paging. The reference
also packs its reset, its scan block and the pytree backend's three
functions, all of them jits. Here the slot reset and the block wave are
eager code around the one program (``runtime/residency.py``; on the card
the block wave is captured as a CUDA graph at construction, which no
pack can hold), and the residency-off backend runs the model's step
eagerly, so no entry stands for them.

The program is device-independent: it was traced on ``meta``, its
custom ops (``repro_torch::flash_decode``, ``flash_decode_paged``,
``ssd_chunk``) dispatch by the device of their tensors at run time, and
the kernels are built at their first launch. So the pack's key is the
runtime, the torch version (a saved program is read by the torch that
wrote it) and ``device_type`` ``meta``, and no compute capability.
"""

from __future__ import annotations

import hashlib
import io
from typing import Any

import torch
import torch.utils._pytree as pytree

from repro_torch.core.artifact import (PORT_RUNTIME, ExecutablePack, PlanBundle,
                                      executable_entry, graph_fingerprint,
                                      port_executable_entries)
from repro_torch.core.unified import PagedStatePlan, StatePlan
from repro_torch.trace.fx_liveness import FxTrace, trace_from_graph_module

# the device a packed program is traced on; the loader retargets it
PROGRAM_DEVICE = "meta"

# the port-side list of a complete pack's entries (core/artifact keeps it
# free of torch.export so the bundle lint can read it)
expected_executable_entries = port_executable_entries


def decode_entry(paged: bool) -> str:
    """The pack entry holding the decode program of a bucket."""
    return port_executable_entries(paged=paged)[0]


def serialize_program(trace: FxTrace, args: tuple) -> bytes:
    """One traced decode program -> bundle payload bytes: ``torch.export``
    of ``trace.gm`` on ``args`` (the program's own, on ``meta``), saved
    without its example inputs."""
    with torch.no_grad():
        ep = torch.export.export(trace.gm, tuple(args), strict=False)
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def _register_ops() -> None:
    """Register the custom ops a program may call before ``torch.export``
    resolves them."""
    import repro_torch.kernels.flash_decode  # noqa: F401
    import repro_torch.kernels.ssd_chunk  # noqa: F401


def _retarget(gm: torch.fx.GraphModule, device: torch.device) -> None:
    """Move a program traced on ``meta`` onto ``device``: every node's
    value metadata on ``meta`` (fake tensors of the same shapes, strides
    and dtypes) and every ``device`` argument naming ``meta``; what names
    another device (a copy to the host) stays, for the lint to find. A
    constant tensor would have been traced without its values, so one
    raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def val(v):
        if not isinstance(v, torch.Tensor) or v.device.type != PROGRAM_DEVICE:
            return v
        with mode:
            return torch.empty_strided(tuple(v.shape), tuple(v.stride()),
                                       dtype=v.dtype, device=device)

    def arg(a):
        if isinstance(a, torch.device) and a.type == PROGRAM_DEVICE:
            return device
        return a

    for node in gm.graph.nodes:
        node.args = torch.fx.node.map_aggregate(node.args, arg)
        node.kwargs = torch.fx.node.map_aggregate(node.kwargs, arg)
        if "val" in node.meta:
            node.meta["val"] = pytree.tree_map(val, node.meta["val"])
    gm.recompile()


def deserialize_program(payload: bytes, *, device, name: str) -> FxTrace:
    """Inverse of :func:`serialize_program`, on ``device``: the program's
    :class:`~repro_torch.trace.fx_liveness.FxTrace`, ready to be an
    ``ArenaExecutor``'s program. Nothing is traced. A program with nodes
    the executor cannot run (a constant traced on ``meta`` has no values;
    a submodule call) raises ``ValueError``."""
    _register_ops()
    ep = torch.export.load(io.BytesIO(payload))
    gm = ep.module()
    other = {n.op for n in gm.graph.nodes} - {"placeholder", "call_function", "output"}
    if other:
        raise ValueError(f"program holds {sorted(other)} nodes, which the arena "
                         f"executor cannot run")
    _retarget(gm, torch.device(device))
    return trace_from_graph_module(gm, name=name)


def build_decode_executables(
    cfg: Any,
    state_plan: StatePlan,
    *,
    n_slots: int,
    max_len: int,
    cores: str = "kernel",
    program=None,
    trace: FxTrace | None = None,
) -> ExecutablePack:
    """Trace and pack the decode program of one serving bucket.

    The program is ``runtime/engine.decode_program`` over ``state_plan``
    on ``meta`` with shape-only parameters; ``launch/compile.py`` passes
    the ``program`` and ``trace`` it already made, so a compile traces
    once."""
    if program is None:
        from repro_torch.models.api import DecoderModel
        from repro_torch.runtime.engine import decode_program

        model = DecoderModel(cfg, PROGRAM_DEVICE, cores=cores)
        program = decode_program(model, model.init(None), state_plan,
                                 n_slots=n_slots, max_len=max_len,
                                 device=PROGRAM_DEVICE)
    devices = {x.device.type for x in pytree.tree_leaves(program.args)
               if isinstance(x, torch.Tensor)}
    if devices != {PROGRAM_DEVICE}:
        raise ValueError(f"a packed program is traced on {PROGRAM_DEVICE}, "
                         f"this one on {sorted(devices)}")
    if trace is None:
        trace = program.trace()
    paged = isinstance(state_plan, PagedStatePlan)
    return ExecutablePack(
        entries={decode_entry(paged): executable_entry(
            serialize_program(trace, program.args))},
        runtime=PORT_RUNTIME,
        torch_version=torch.__version__,
        device_type=PROGRAM_DEVICE,
    )


def load_executables(bundle: PlanBundle, *, device) -> tuple[dict[str, FxTrace], str | None]:
    """The serving-side load-or-refuse gate: ``(loaded programs,
    warning)``, the programs on ``device``. All or nothing: any refusal
    drops the WHOLE pack and returns the one-line reason. ``({}, None)``
    for a bundle that carries no pack."""
    pack = bundle.executables
    if pack is None:
        return {}, None
    fallback = "falling back to tracing the decode step"
    if not pack.is_port:
        return {}, (
            f"AOT executables were compiled for platform {pack.platform!r} "
            f"under jax {pack.jax_version}, not by {PORT_RUNTIME}; {fallback}"
        )
    if pack.torch_version != torch.__version__:
        return {}, (
            f"AOT executables were compiled under torch {pack.torch_version} "
            f"but this process runs torch {torch.__version__}; {fallback}"
        )
    if pack.device_type != PROGRAM_DEVICE:
        return {}, (
            f"AOT executables were traced on {pack.device_type!r}, not "
            f"{PROGRAM_DEVICE!r}; {fallback}"
        )
    want = port_executable_entries(
        paged=isinstance(bundle.state_plan, PagedStatePlan))
    if sorted(pack.entries) != want:
        return {}, (
            f"AOT pack carries {sorted(pack.entries)}, this bucket's is "
            f"{want}; {fallback}"
        )
    loaded: dict[str, FxTrace] = {}
    for name, entry in sorted(pack.entries.items()):
        if hashlib.sha256(entry.payload).hexdigest() != entry.sha256:
            return {}, (
                f"AOT executable {name!r} failed its payload integrity "
                f"check; {fallback}"
            )
        try:
            trace = deserialize_program(entry.payload, device=device,
                                        name=f"{bundle.arch}-decode")
        except Exception as e:
            return {}, (
                f"AOT executable {name!r} failed to deserialize "
                f"({type(e).__name__}: {e}); {fallback}"
            )
        fresh = graph_fingerprint(trace.graph)
        if fresh != bundle.graph_fingerprint:
            return {}, (
                f"AOT executable {name!r} is not the bundle's graph (program "
                f"{fresh[:12]}, bundle {str(bundle.graph_fingerprint)[:12]}); "
                f"{fallback}"
            )
        loaded[name] = trace
    return loaded, None


def inputs_mismatch(trace: FxTrace, args: tuple) -> str | None:
    """Why a loaded program cannot take ``args`` (None when it can): the
    structure of the arguments (the reference's ``in_tree``), then each
    flat input's shape, strides and dtype against its placeholder."""
    info = getattr(trace.gm.graph._codegen, "pytree_info", None)
    flat, spec = pytree.tree_flatten((tuple(args), {}))
    if info is None or info.in_spec != spec:
        return "its inputs are not this engine's step arguments (structure)"
    places = [n.meta.get("val") for n in trace.gm.graph.nodes if n.op == "placeholder"]
    for i, (x, v) in enumerate(zip(flat, places)):
        if not isinstance(x, torch.Tensor):
            continue
        if not isinstance(v, torch.Tensor) or (tuple(x.shape), tuple(x.stride()),
                                              x.dtype) != (tuple(v.shape),
                                                           tuple(v.stride()), v.dtype):
            return (f"input {i} is {tuple(x.shape)} {x.dtype}, the program "
                    f"takes {None if v is None else (tuple(v.shape), v.dtype)}")
    return None


__all__ = [
    "build_decode_executables",
    "decode_entry",
    "deserialize_program",
    "expected_executable_entries",
    "inputs_mismatch",
    "load_executables",
    "serialize_program",
]
