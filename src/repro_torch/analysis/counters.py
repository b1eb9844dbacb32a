"""One registry over the port's process-wide instrumentation counters.

Port of the reference's ``analysis/counters.py``. The hot paths count
with module-global integers that tests and ``chip_smoke.py`` take deltas
of; here they are one named registry:

    from repro_torch.analysis import counters

    with counters.capture() as cap:
        engine.run_until_done()
    assert cap.delta("capture_calls") == 0
    assert cap.delta("host_syncs") == engine.n_blocks

``capture_calls`` stands in for the reference's ``compile_calls``: a
CUDA graph capture is the port's compile. Counters are looked up lazily
by (module, attribute).
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Iterator

# name -> (module, attribute) holding an int module-global
REGISTRY: dict[str, tuple[str, str]] = {
    "trace_calls": ("repro_torch.trace.fx_liveness", "TRACE_CALLS"),
    "plan_calls": ("repro_torch.core.planner", "PLAN_CALLS"),
    "state_plan_calls": ("repro_torch.core.unified", "STATE_PLAN_CALLS"),
    "host_syncs": ("repro_torch.runtime.engine", "HOST_SYNCS"),
    "capture_calls": ("repro_torch.runtime.graphs", "CAPTURE_CALLS"),
}


def read(name: str) -> int:
    """Current value of one registered counter."""
    mod_name, attr = REGISTRY[name]
    return getattr(importlib.import_module(mod_name), attr)


def snapshot(names: tuple[str, ...] | None = None) -> dict[str, int]:
    """Read every (or the named) registered counters at once."""
    return {n: read(n) for n in (names or tuple(REGISTRY))}


def reset(names: tuple[str, ...] | None = None) -> None:
    """Zero the named counters (all by default)."""
    for n in names or tuple(REGISTRY):
        mod_name, attr = REGISTRY[n]
        setattr(importlib.import_module(mod_name), attr, 0)


class Capture:
    """Deltas of the registered counters since ``capture()`` entry."""

    def __init__(self, names: tuple[str, ...]):
        self.names = names
        self.start = snapshot(names)

    def delta(self, name: str) -> int:
        return read(name) - self.start[name]

    def deltas(self) -> dict[str, int]:
        return {n: self.delta(n) for n in self.names}


@contextlib.contextmanager
def capture(*names: str) -> Iterator[Capture]:
    """Snapshot counters on entry; ``cap.delta(name)`` reads live deltas.
    With no arguments captures every registered counter. Nothing is
    reset, so captures nest."""
    yield Capture(names or tuple(REGISTRY))
