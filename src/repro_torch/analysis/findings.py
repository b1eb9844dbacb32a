"""Findings model shared by every analysis pass.

A pass returns a flat list of :class:`Finding`; drivers collect them into
a :class:`Report`. Severity semantics:

* ``error``   — the artifact is unsound or would misbehave (memory
  collision, missing donation, stale fingerprint). Gates refuse on these.
* ``warning`` — suspicious but survivable (bucket coverage gap, known
  backend copy artifact, deprecated format). Gates refuse on these only
  under ``--strict``.
"""

from __future__ import annotations

import dataclasses

SEVERITIES = ("error", "warning")


class LintGateError(RuntimeError):
    """A gate (pre-publish in ``launch/compile.py``, optional engine
    startup) refused an artifact over error-severity findings. Carries
    the full :class:`Report` so callers can render or serialize it."""

    def __init__(self, report: "Report", context: str = ""):
        self.report = report
        prefix = f"{context}: " if context else ""
        super().__init__(
            f"{prefix}{len(report.errors)} error-severity finding(s)\n"
            + report.render()
        )


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect surfaced by a pass.

    ``where`` locates the artifact (tensor ids, bucket key, HLO op name);
    ``code`` is the stable machine-readable check identifier the mutation
    harness and CI asserts key on.
    """

    pass_name: str  # "soundness" | "decode_lint" | "bundle_lint"
    code: str  # e.g. "arena-collision", "state-not-donated"
    message: str
    where: str = ""
    severity: str = "error"

    def __post_init__(self) -> None:
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}"
            )

    def render(self) -> str:
        loc = f" @ {self.where}" if self.where else ""
        return (
            f"{self.severity.upper()} {self.pass_name}[{self.code}]{loc}: "
            f"{self.message}"
        )

    def to_obj(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    """Findings from one or more passes over one or more artifacts."""

    findings: list[Finding] = dataclasses.field(default_factory=list)
    # pass/target labels that ran to completion (also when clean), so a
    # zero-findings report still shows WHAT was checked
    checked: list[str] = dataclasses.field(default_factory=list)

    def extend(self, findings: list[Finding], *, checked: str | None = None):
        self.findings.extend(findings)
        if checked is not None:
            self.checked.append(checked)
        return self

    def merge(self, other: "Report") -> "Report":
        self.findings.extend(other.findings)
        self.checked.extend(other.checked)
        return self

    @property
    def errors(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list[Finding]:
        return [f for f in self.findings if f.severity == "warning"]

    def ok(self, *, strict: bool = False) -> bool:
        return not (self.findings if strict else self.errors)

    def render(self) -> str:
        lines = [f.render() for f in self.findings]
        lines.append(
            f"{len(self.checked)} target(s) checked: "
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s)"
        )
        return "\n".join(lines)

    def to_obj(self) -> dict:
        return {
            "findings": [f.to_obj() for f in self.findings],
            "checked": list(self.checked),
            "errors": len(self.errors),
            "warnings": len(self.warnings),
        }
