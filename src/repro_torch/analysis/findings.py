"""Findings model + baseline file IO for the analysis suite.

A ``Finding`` is one rule violation at one source location. Its
``key`` — ``rule:path:scope:detail`` — deliberately excludes the line
number, so a baseline survives unrelated edits to the same file; two
identical violations in one scope disambiguate with an ordinal suffix.

The baseline file (``analysis_baseline_torch.json`` for the port) is a
committed list of grandfathered findings, each carrying a ``why`` —
baselines are for deliberate, justified exceptions, not a landfill for
unfixed bugs. The format is the JAX package's suite's, so the two
baselines read alike.
"""
from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, List, Sequence


class Severity(str, enum.Enum):
    ERROR = "error"        # breaks a main-path invariant
    WARNING = "warning"    # hazard: correct today, fragile tomorrow


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str              # e.g. "JB02"
    severity: Severity
    path: str              # repo-relative posix path
    line: int              # 1-indexed
    scope: str             # enclosing function/class qualname ("" = module)
    message: str           # what is wrong
    hint: str              # how to fix it
    detail: str = ""       # stable discriminator (symbol / expression)

    @property
    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.scope}:{self.detail}"

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        scope = f" [{self.scope}]" if self.scope else ""
        return (f"{self.severity.value.upper():7s} {self.rule} {where}"
                f"{scope}\n    {self.message}\n    fix: {self.hint}")

    def to_json(self) -> Dict:
        return {
            "rule": self.rule,
            "severity": self.severity.value,
            "path": self.path,
            "line": self.line,
            "scope": self.scope,
            "message": self.message,
            "hint": self.hint,
            "detail": self.detail,
            "key": self.key,
        }


def dedupe_keys(findings: Sequence[Finding]) -> List[str]:
    """Baseline keys with ordinal suffixes for repeated identical keys
    (two ``float()`` calls on one tensor in one function must not
    collapse to a single baseline entry)."""
    seen: Dict[str, int] = {}
    out = []
    for f in findings:
        n = seen.get(f.key, 0)
        seen[f.key] = n + 1
        out.append(f.key if n == 0 else f"{f.key}#{n}")
    return out


def load_baseline(path: str) -> Dict[str, str]:
    """Baseline file -> {key: why}. Missing file = empty baseline."""
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return {}
    entries = data.get("findings", [])
    out: Dict[str, str] = {}
    for e in entries:
        why = e.get("why", "")
        if not why:
            raise ValueError(
                f"baseline entry {e.get('key')!r} has no 'why': every "
                "grandfathered finding needs an inline justification")
        out[e["key"]] = why
    return out


def save_baseline(path: str, findings: Sequence[Finding],
                  whys: Dict[str, str] | None = None) -> None:
    """Write the current findings as the new baseline. ``whys`` maps
    keys to justifications; keys without one get a TODO marker that
    ``load_baseline`` rejects — forcing a human to justify each entry."""
    whys = whys or {}
    entries = []
    for f, key in zip(findings, dedupe_keys(findings)):
        entries.append({
            "key": key,
            "rule": f.rule,
            "path": f.path,
            "why": whys.get(key, whys.get(f.key, "")),
        })
    with open(path, "w") as fh:
        json.dump({"findings": entries}, fh, indent=2, sort_keys=False)
        fh.write("\n")


def split_new(findings: Sequence[Finding],
              baseline: Dict[str, str]):
    """(new, grandfathered) under the baseline's keys, with ordinal
    suffixes applied the same way ``save_baseline`` writes them."""
    new, old = [], []
    for f, key in zip(findings, dedupe_keys(findings)):
        (old if key in baseline else new).append(f)
    return new, old


def report_json(findings: Sequence[Finding],
                baseline: Dict[str, str]) -> Dict:
    new, old = split_new(findings, baseline)
    return {
        "total": len(findings),
        "new": [f.to_json() for f in new],
        "baselined": [f.to_json() for f in old],
    }
