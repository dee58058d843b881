"""Orchestrates the passes over a scanned project index."""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

from repro_torch.analysis.core import ProjectIndex, build_index
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.passes import PASSES

_PREFIX_TO_PASS = {
    "JB": "host_sync", "RT": "retrace", "PT": "pytree",
    "LK": "locks", "KW": "kernel_hygiene",
}


def run_analysis(paths: Sequence[str], repo_root: str = ".",
                 rules: Optional[Sequence[str]] = None,
                 index: Optional[ProjectIndex] = None,
                 roots: Optional[Mapping] = None) -> List[Finding]:
    """Run every registered pass and return all findings sorted by
    (path, line, rule) for stable output/diffs.

    ``rules`` filters by pass name ("locks"), rule id ("JB02") or rule-id
    prefix ("LK"). ``roots`` replaces ``core.HOT_PATH_ROOTS`` as the
    hot path's entry points.
    """
    idx = index if index is not None else build_index(paths, repo_root,
                                                      roots)
    findings: List[Finding] = []
    for pass_fn in PASSES.values():
        findings.extend(pass_fn(idx))
    if rules:
        keep = set(rules)
        findings = [
            f for f in findings
            if f.rule in keep or f.rule[:2] in keep
            or _PREFIX_TO_PASS.get(f.rule[:2]) in keep
        ]
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.detail))
    return findings
