"""Finding/report datatypes for the port's cimcheck static analysis.

Counterpart of `repro/analysis/findings.py`, kept as the port's own copy.
Every cimcheck pass (see `repro_torch.analysis`) reports problems as `Finding`
records collected into a `Report`.  A finding carries a pass id (e.g.
``"barriers"``), a stable machine-readable code (e.g. ``"NB001"``), a
severity, a human message, and an optional source location / layer index.

Reports support fnmatch-style suppressions so known-benign findings can be
waived without weakening a pass globally, and serialize to JSON for the CI
artifact (`python -m repro_torch.analysis --json`), which
`Report.from_json` reads back.
"""
from __future__ import annotations

import enum
import fnmatch
import json
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple


class Severity(enum.IntEnum):
    """Finding severity; ERROR fails --strict / verify="strict"."""

    INFO = 0
    WARNING = 1
    ERROR = 2


@dataclass(frozen=True)
class Finding:
    """One problem reported by a cimcheck pass."""

    pass_id: str            # which pass produced it ("barriers", "noise", ...)
    code: str               # stable machine code ("NB001", "NK002", ...)
    severity: Severity
    message: str
    where: str = ""         # source location / op path, best effort
    layer: Optional[int] = None

    def format(self) -> str:
        """Render the finding as a one-line human-readable string."""
        loc = f" @ {self.where}" if self.where else ""
        lyr = f" [layer {self.layer}]" if self.layer is not None else ""
        return (f"{self.severity.name}: {self.pass_id}/{self.code}{lyr}: "
                f"{self.message}{loc}")

    def to_dict(self) -> dict:
        """Serialize to a plain JSON-compatible dict."""
        return {
            "pass": self.pass_id,
            "code": self.code,
            "severity": self.severity.name,
            "message": self.message,
            "where": self.where,
            "layer": self.layer,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        """The finding `to_dict` serialized."""
        return cls(pass_id=d["pass"], code=d["code"],
                   severity=Severity[d["severity"]], message=d["message"],
                   where=d.get("where", ""), layer=d.get("layer"))


@dataclass(frozen=True)
class Suppression:
    """fnmatch pattern waiving findings: matches pass_id and code."""

    pass_id: str = "*"
    code: str = "*"
    reason: str = ""

    def matches(self, finding: Finding) -> bool:
        """True when this suppression waives the given finding."""
        return (fnmatch.fnmatch(finding.pass_id, self.pass_id)
                and fnmatch.fnmatch(finding.code, self.code))


class CimcheckError(RuntimeError):
    """Raised by strict verification when a report contains errors."""

    def __init__(self, report: "Report"):
        self.report = report
        lines = [f.format() for f in report.errors()]
        super().__init__(
            "cimcheck found %d error(s):\n%s" % (len(lines), "\n".join(lines)))


@dataclass
class Report:
    """Accumulated findings from one or more cimcheck passes."""

    findings: List[Finding] = field(default_factory=list)
    suppressions: Tuple[Suppression, ...] = ()
    suppressed: List[Finding] = field(default_factory=list)

    def add(self, finding: Finding) -> None:
        """Record a finding, routing it to `suppressed` when waived."""
        for sup in self.suppressions:
            if sup.matches(finding):
                self.suppressed.append(finding)
                return
        self.findings.append(finding)

    def extend(self, findings: Iterable[Finding]) -> None:
        """Record several findings through the suppression filter."""
        for f in findings:
            self.add(f)

    def merge(self, other: "Report") -> None:
        """Fold another report's findings into this one (re-filtering)."""
        self.extend(other.findings)
        self.suppressed.extend(other.suppressed)

    def errors(self) -> List[Finding]:
        """Findings at ERROR severity."""
        return [f for f in self.findings if f.severity >= Severity.ERROR]

    def warnings(self) -> List[Finding]:
        """Findings at WARNING severity."""
        return [f for f in self.findings if f.severity == Severity.WARNING]

    def codes(self) -> List[str]:
        """The (unsuppressed) finding codes, in report order."""
        return [f.code for f in self.findings]

    def ok(self) -> bool:
        """True when no unsuppressed ERROR findings exist."""
        return not self.errors()

    def raise_if(self, mode: str = "strict") -> "Report":
        """Enforce a verification mode over this report.

        ``"strict"`` raises `CimcheckError` on any ERROR finding; ``"warn"``
        prints findings to stderr; ``"off"`` does nothing.  Returns self so
        calls chain.
        """
        if mode == "off":
            return self
        if mode == "warn":
            import sys
            for f in self.findings:
                print("cimcheck: " + f.format(), file=sys.stderr)
            return self
        if mode == "strict":
            if not self.ok():
                raise CimcheckError(self)
            return self
        raise ValueError(f"unknown cimcheck mode {mode!r}; "
                         "expected 'strict', 'warn' or 'off'")

    def to_json(self, indent: Optional[int] = 2) -> str:
        """Serialize the report (findings + suppressed) to a JSON string."""
        payload = {
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "ok": self.ok(),
        }
        return json.dumps(payload, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "Report":
        """The report `to_json` wrote (findings and suppressed findings;
        the suppression patterns themselves are not serialized)."""
        payload = json.loads(text)
        return cls(findings=[Finding.from_dict(d)
                             for d in payload.get("findings", [])],
                   suppressed=[Finding.from_dict(d)
                               for d in payload.get("suppressed", [])])


def parse_suppressions(specs: Sequence[str]) -> Tuple[Suppression, ...]:
    """Parse CLI-style suppression specs ``pass_id/code[:reason]``."""
    out = []
    for spec in specs:
        body, _, reason = spec.partition(":")
        pass_id, _, code = body.partition("/")
        out.append(Suppression(pass_id=pass_id or "*", code=code or "*",
                               reason=reason))
    return tuple(out)
