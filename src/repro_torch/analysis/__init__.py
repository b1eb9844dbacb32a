"""Static analysis for plans and the live serving loop (the port's
counterpart of ``repro.analysis``).

* :mod:`~repro_torch.analysis.soundness` — the plan soundness certifier:
  an O(n log n) sweep-line re-derivation of liveness + arena disjointness
  (plus StatePlan bounds/alignment/disjointness) that shares zero code
  with ``core/interval_set`` or the planners, differential-matched
  against the O(n²) oracle in ``core/validate``. The engine runs it at
  startup with ``startup_lint=True``, and ``launch/compile.plan_prefill``
  on every prefill plan it returns;
* :mod:`~repro_torch.analysis.decode_lint` — checks a live engine while it
  serves (no host sync inside a block, the state and the arena never
  move, no capture after warm-up);
* :mod:`~repro_torch.analysis.counters` — one registry over the
  process-wide instrumentation counters.
"""

from repro_torch.analysis.findings import Finding, LintGateError, Report

__all__ = ["Finding", "LintGateError", "Report"]
