"""One diagnostic stream for every static pass (the port's copy).

The port's counterpart of the JAX package's ``analysis/diagnostics.py``,
kept as its own copy so that ``repro_torch`` imports nothing of
``repro``.  The schedule checker, the contract checker, the sanitizer
and the port's lint all report through the same :class:`Diagnostic`
shape, so CI can collect one JSON artifact and the ``verify=`` plumbing
can apply one severity policy.  A diagnostic carries a stable rule code
(``SCHED001``, ``CON002``, ``REP004``, ...), a severity, *where* (a
source location for lint findings, a plan key / entry tag for plan-level
findings), and a fix hint — the hint is the contract: every rule must
tell the reader what to change, not just what is wrong.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding from one static pass."""
    code: str                      # stable rule code, e.g. "SCHED001"
    severity: str                  # "error" | "warning" | "info"
    message: str                   # what is wrong, concretely
    hint: str = ""                 # what to change to fix it
    # Location: lint findings fill path/line; plan-level findings fill
    # plan_key (a string rendering of the plan/entry identity).
    path: Optional[str] = None
    line: Optional[int] = None
    plan_key: Optional[str] = None

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    def where(self) -> str:
        if self.path is not None:
            return (f"{self.path}:{self.line}" if self.line is not None
                    else self.path)
        return self.plan_key or "<plan>"

    def render(self) -> str:
        s = f"{self.where()}: {self.code} [{self.severity}] {self.message}"
        if self.hint:
            s += f"  (fix: {self.hint})"
        return s

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None and v != ""}


class DiagnosticReport:
    """An ordered collection of diagnostics from one or more passes.

    Identical findings (same code + where + message) reported by more
    than one pass collapse to one record — ``DistributedFFT.verify()``
    and the executor's verify path each stack several passes over the
    same plan/queue, and a reader counting errors must not double-count
    one defect.
    """

    def __init__(self, diagnostics: Sequence[Diagnostic] = ()):
        self.diagnostics: List[Diagnostic] = []
        self._seen: set = set()
        for d in diagnostics:
            self.add(d)

    def add(self, diag: Diagnostic) -> None:
        key = (diag.code, diag.where(), diag.message)
        if key in self._seen:
            return
        self._seen.add(key)
        self.diagnostics.append(diag)

    def extend(self, other: "DiagnosticReport") -> None:
        for d in other.diagnostics:
            self.add(d)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def __bool__(self) -> bool:
        return bool(self.diagnostics)

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def by_code(self, code: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def render(self) -> str:
        return "\n".join(d.render() for d in self.diagnostics)

    def to_json(self, *, indent: Optional[int] = 1) -> str:
        # Deterministic ordering (code, then where) regardless of which
        # pass emitted first — CI artifacts diff cleanly across runs.
        ordered = sorted(self.diagnostics,
                         key=lambda d: (d.code, d.where(), d.message))
        payload = {
            "count": len(self.diagnostics),
            "errors": len(self.errors),
            "diagnostics": [d.to_dict() for d in ordered],
        }
        return json.dumps(payload, indent=indent, sort_keys=True)


class PlanVerificationError(RuntimeError):
    """Raised under ``verify="strict"`` when a pass reports errors.

    Carries the full report so callers can inspect/serialize what was
    found rather than re-running the pass.
    """

    def __init__(self, report: DiagnosticReport, context: str = ""):
        self.report = report
        head = f"static verification failed ({context})" if context \
            else "static verification failed"
        super().__init__(
            f"{head}: {len(report.errors)} error(s)\n{report.render()}")
