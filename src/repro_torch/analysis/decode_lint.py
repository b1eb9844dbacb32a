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
    state_ptr = engine.state.buf.data_ptr()
    arena_ptr = engine.activation_arena.buf.data_ptr()
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
    if engine.state.buf.data_ptr() != state_ptr:
        findings.append(_finding(
            "state-buffer-moved",
            "the state buffer moved during the run; the captured graphs "
            "still address the old one", where))
    if engine.activation_arena.buf.data_ptr() != arena_ptr:
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
