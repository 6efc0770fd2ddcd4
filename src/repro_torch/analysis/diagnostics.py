"""Shared diagnostic vocabulary for the verifier and the linter.

The plan verifier reports findings as frozen :class:`Diagnostic` records —
a rule id, a severity, where it happened (node/stage for plans, path/line
for source), and a fix hint — so the gates and the tests consume one
format.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence

# Severity levels, mildest first.  Only "error" diagnostics make
# ``check_plan`` raise; "warning" findings are reported but non-fatal.
Severity = str
WARNING: Severity = "warning"
ERROR: Severity = "error"

#: Environment knob: set ``REPRO_VERIFY=off`` (or 0/false/no) to disable the
#: plan-verification gate in ``PipelineGenerator.generate``.
VERIFY_ENV = "REPRO_VERIFY"


def verify_enabled() -> bool:
    """True unless the ``REPRO_VERIFY`` escape hatch disables the gate."""
    return os.environ.get(VERIFY_ENV, "").strip().lower() not in (
        "off", "0", "false", "no")


@dataclass(frozen=True)
class Diagnostic:
    """One finding from a verify or lint rule."""

    rule: str                       # registered rule id, e.g. "produced-once"
    message: str                    # human-readable statement of the defect
    severity: Severity = ERROR
    node: Optional[str] = None      # IR node name (verify rules)
    stage: Optional[str] = None     # plan stage name (verify rules)
    path: Optional[str] = None      # source file (lint rules)
    line: Optional[int] = None      # 1-based source line (lint rules)
    hint: Optional[str] = None      # suggested fix

    def format(self) -> str:
        where = []
        if self.path:
            where.append(f"{self.path}:{self.line}" if self.line else self.path)
        if self.stage:
            where.append(f"stage={self.stage}")
        if self.node:
            where.append(f"node={self.node}")
        loc = " ".join(where)
        out = f"{self.severity}[{self.rule}]"
        if loc:
            out += f" {loc}"
        out += f": {self.message}"
        if self.hint:
            out += f"  (hint: {self.hint})"
        return out


class PlanVerificationError(ValueError):
    """A plan failed static verification at a gate.

    Carries the structured diagnostics so callers can inspect rule ids
    instead of parsing text.
    """

    def __init__(self, where: str, diagnostics: Sequence[Diagnostic]):
        self.where = where
        self.diagnostics = list(diagnostics)
        lines = "\n  ".join(d.format() for d in self.diagnostics)
        super().__init__(
            f"plan verification failed at {where} "
            f"({len(self.diagnostics)} finding(s)):\n  {lines}")

    @property
    def rules(self) -> list:
        return sorted({d.rule for d in self.diagnostics})
