"""PT* — the writer-plane partition of a frozen state dataclass
(DESIGN.md §13).

The gateway's conflict-free publish merge copies only the learner's
plane back (``types.merge_learn_leaves``), so the planes must say
exactly who owns each field:

  PT01  a writer-plane partition (the ``*_LEAVES`` tuples) that does not
        cover the frozen dataclass's fields exactly — a field missing
        from every plane has no owner and silently loses writes in the
        publish merge; a name that is not a field is dead weight that
        masks the first problem.
  PT02  two planes claiming the same leaf — concurrent writers, torn
        merges.

Any module defining two or more ``*_LEAVES`` tuples is checked against
the frozen ``dataclasses.dataclass`` whose fields best overlap their
union, so the rule fires on fixtures and on future state classes alike.
``types.validate_leaf_partition`` is the runtime twin. The JAX suite's
PT03 and PT04 concern pytree registration, which the port does not use.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from repro_torch.analysis.core import ModuleInfo, ProjectIndex, dotted
from repro_torch.analysis.findings import Finding, Severity


def _frozen_dataclasses(mod: ModuleInfo) -> List[ast.ClassDef]:
    out = []
    for node in mod.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        for dec in node.decorator_list:
            if not isinstance(dec, ast.Call):
                continue
            name = mod.resolve(dec.func) or ""
            frozen = any(kw.arg == "frozen" and isinstance(
                kw.value, ast.Constant) and kw.value.value is True
                for kw in dec.keywords)
            if name.endswith("dataclasses.dataclass") and frozen:
                out.append(node)
                break
    return out


def _dataclass_fields(cls: ast.ClassDef) -> Set[str]:
    """Annotated class-body names, less ``ClassVar``s."""
    out = set()
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name):
            ann = stmt.annotation
            if isinstance(ann, ast.Subscript):
                ann = ann.value
            if (dotted(ann) or "").endswith("ClassVar"):
                continue
            out.add(stmt.target.id)
    return out


def _leaf_partitions(mod: ModuleInfo) -> Dict[str, Tuple[int, Tuple[str, ...]]]:
    """Module-level ``X_LEAVES = ("a", "b", ...)`` tuples."""
    out: Dict[str, Tuple[int, Tuple[str, ...]]] = {}
    for node in mod.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Name) and tgt.id.endswith("_LEAVES")):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            names = tuple(
                e.value for e in node.value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str))
            if len(names) == len(node.value.elts):
                out[tgt.id] = (node.lineno, names)
    return out


def _check_partitions(mod: ModuleInfo) -> List[Finding]:
    parts = _leaf_partitions(mod)
    if len(parts) < 2:
        return []
    union: Set[str] = set()
    for _line, names in parts.values():
        union |= set(names)
    # the dataclass these planes partition = best field overlap
    best, best_fields, best_overlap = None, set(), 0
    for cls in _frozen_dataclasses(mod):
        fields = _dataclass_fields(cls)
        overlap = len(union & fields)
        if overlap > best_overlap:
            best, best_fields, best_overlap = cls, fields, overlap
    if best is None:
        return []
    out: List[Finding] = []
    first_line = min(line for line, _ in parts.values())
    for name in sorted(best_fields - union):
        out.append(Finding(
            rule="PT01", severity=Severity.ERROR,
            path=mod.path, line=first_line, scope=best.name,
            message=f"field {name!r} of {best.name} belongs to no writer "
                    "plane: writes to it are silently lost in the "
                    "publish merge",
            hint="add it to exactly one of the *_LEAVES partitions",
            detail=f"missing:{name}"))
    for name in sorted(union - best_fields):
        out.append(Finding(
            rule="PT01", severity=Severity.ERROR,
            path=mod.path, line=first_line, scope=best.name,
            message=f"partition name {name!r} is not a field of "
                    f"{best.name}",
            hint="remove the stale name (field renamed or deleted?)",
            detail=f"unknown:{name}"))
    items = sorted(parts.items())
    for i, (na, (la, a)) in enumerate(items):
        for nb, (lb, b) in items[i + 1:]:
            for name in sorted(set(a) & set(b)):
                out.append(Finding(
                    rule="PT02", severity=Severity.ERROR,
                    path=mod.path, line=min(la, lb), scope=best.name,
                    message=f"leaf {name!r} is claimed by both {na} and "
                            f"{nb}: two writer planes on one leaf means "
                            "torn publish merges",
                    hint="assign the leaf to exactly one plane",
                    detail=f"overlap:{name}:{na}:{nb}"))
    return out


def run(idx: ProjectIndex) -> List[Finding]:
    out: List[Finding] = []
    for mod in idx.modules:
        out.extend(_check_partitions(mod))
    return out
