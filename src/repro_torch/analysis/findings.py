"""Finding model + committed-baseline diffing for the analysis passes
(port of ``repro.analysis.findings``; the same keys and file format).

Every analysis pass (AST lint, sync guard, invariants) emits
:class:`Finding` records. A finding's :attr:`Finding.key` is *stable
across line-number churn*: it is built from the rule, the repo-relative
path, the enclosing symbol and a per-symbol occurrence discriminator —
NOT the line number — so reformatting a file does not invalidate the
committed baseline.

Baseline workflow (``scripts/analyze_torch.py``):

  * ``analysis/baseline_torch.json`` grandfathers pre-existing debt: a
    finding whose key appears there is reported but does not fail the
    run.
  * a NEW finding (key absent from the baseline) fails the gate;
  * a FIXED finding (baselined key no longer emitted) is reported so the
    baseline can be re-tightened with ``scripts/analyze_torch.py
    --update``.

Severities: ``error`` findings gate (modulo baseline); ``warn`` findings
gate the same way but mark debt worth burning down; ``info`` findings
are classification output only — never baselined, never fatal.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, List, Tuple

SEVERITIES = ("error", "warn", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis finding.

    Attributes:
      rule: rule identifier (e.g. ``host-sync``; the module docstring of
        :mod:`repro_torch.analysis.astlint` has the full table).
      path: repo-relative posix path of the offending file ('' for
        dynamic findings with no single source line).
      line: 1-based source line (0 when not applicable). Display only —
        never part of the key.
      symbol: dotted qualname of the enclosing function/class, or
        ``<module>`` / an entry-point name for dynamic findings.
      detail: stable per-symbol discriminator (call name + occurrence
        index, invariant name, ...).
      message: human-readable description.
      severity: ``error`` | ``warn`` | ``info``.
      suggestion: optional autofix hint printed by the CLI.
    """
    rule: str
    path: str
    line: int
    symbol: str
    detail: str
    message: str
    severity: str = "error"
    suggestion: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"bad severity {self.severity!r}")

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.path}::{self.symbol}::{self.detail}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.path else self.symbol
        out = f"[{self.severity}] {loc}: {self.rule}: {self.message}"
        if self.suggestion:
            out += f"\n    fix: {self.suggestion}"
        return out


BASELINE_VERSION = 1


def load_baseline(path: str) -> Dict[str, dict]:
    """Load ``{finding_key: metadata}`` from a baseline file.

    A missing file is an empty baseline (first run / fresh repo)."""
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"{path}: baseline version {doc.get('version')!r} != "
            f"{BASELINE_VERSION} (regenerate with scripts/analyze_torch.py "
            f"--update)")
    return doc["findings"]


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    """Write the gating findings (error/warn) as the new baseline."""
    doc = {
        "version": BASELINE_VERSION,
        "findings": {
            f.key: {"rule": f.rule, "path": f.path, "line": f.line,
                    "message": f.message, "severity": f.severity}
            for f in sorted(findings, key=lambda f: f.key)
            if f.severity != "info"
        },
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def diff_baseline(findings: Iterable[Finding], baseline: Dict[str, dict],
                  ) -> Tuple[List[Finding], List[Finding], List[str]]:
    """Split findings against the baseline.

    Returns ``(new, grandfathered, fixed_keys)``: gating findings absent
    from the baseline, gating findings the baseline already carries, and
    baselined keys no longer emitted (candidates for --update)."""
    gating = [f for f in findings if f.severity != "info"]
    new = [f for f in gating if f.key not in baseline]
    grandfathered = [f for f in gating if f.key in baseline]
    live_keys = {f.key for f in gating}
    fixed = sorted(k for k in baseline if k not in live_keys)
    return new, grandfathered, fixed
