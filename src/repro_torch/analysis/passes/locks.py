"""LK* — lock discipline on shared mutable serving-plane state
(DESIGN.md §14.4), the JAX package's pass unchanged.

A lockset pass in the classic style: for each class, an attribute is
*guarded* if any method writes it inside a ``with self.<lock>`` block.
Every other write to a guarded attribute must also hold the lock:

  LK01  plain attribute assignment (``self.x = ...`` / ``self.x += ...``)
        to a guarded attribute outside the lock
  LK02  mutating container operation (``self.x.append(...)``,
        ``self.x[k] = ...``, ``.pop/.clear/.update`` ...) on a guarded
        attribute outside the lock

Reads are exempt — the gateway's read path is deliberately wait-free on
an immutable snapshot (§13); the invariant is single-writer-under-lock,
not reader-writer exclusion. Two method classes are exempt by
convention, matching the existing code: ``__init__`` (no concurrent
access before the constructor returns) and ``*_locked`` methods
(documented as called-with-lock-held; the *callers* are checked).
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.core import ModuleInfo, ProjectIndex
from repro_torch.analysis.findings import Finding, Severity

_MUTATORS = {
    "append", "extend", "insert", "pop", "popleft", "popitem", "remove",
    "clear", "update", "setdefault", "add", "discard", "appendleft",
    "sort", "reverse",
}

_EXEMPT_METHODS = {"__init__", "__new__", "__post_init__"}


def _is_lock_expr(node: ast.AST) -> bool:
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and "lock" in node.attr.lower())


def _self_attr(node: ast.AST):
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _method_writes(method: ast.FunctionDef):
    """Yield (attr, kind, node, locked) for every write to a self
    attribute, tracking lexical ``with self.<lock>`` nesting."""

    def walk(node, locked: bool):
        if isinstance(node, ast.With):
            holds = any(_is_lock_expr(item.context_expr)
                        for item in node.items)
            for child in node.body:
                yield from walk(child, locked or holds)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # nested defs have their own discipline
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is not None:
                    yield attr, "LK01", node, locked
                if isinstance(tgt, ast.Subscript):
                    attr = _self_attr(tgt.value)
                    if attr is not None:
                        yield attr, "LK02", node, locked
        elif isinstance(node, ast.AugAssign):
            attr = _self_attr(node.target)
            if attr is not None:
                yield attr, "LK01", node, locked
            if isinstance(node.target, ast.Subscript):
                attr = _self_attr(node.target.value)
                if attr is not None:
                    yield attr, "LK02", node, locked
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is None and isinstance(tgt, ast.Subscript):
                    attr = _self_attr(tgt.value)
                if attr is not None:
                    yield attr, "LK02", node, locked
        elif isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS:
                attr = _self_attr(node.func.value)
                if attr is not None and "lock" not in attr.lower():
                    yield attr, "LK02", node, locked
        for child in ast.iter_child_nodes(node):
            yield from walk(child, locked)

    for stmt in method.body:
        yield from walk(stmt, False)


def _check_class(mod: ModuleInfo, cls: ast.ClassDef) -> List[Finding]:
    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    uses_lock = any(_is_lock_expr(n) for m in methods
                    for n in ast.walk(m))
    if not uses_lock:
        return []

    # pass 1: guarded set = attrs ever written under the lock
    guarded: Set[str] = set()
    for m in methods:
        for attr, _kind, _node, locked in _method_writes(m):
            if locked:
                guarded.add(attr)
    if not guarded:
        return []

    # pass 2: unlocked writes to guarded attrs in non-exempt methods
    out: List[Finding] = []
    for m in methods:
        if m.name in _EXEMPT_METHODS or m.name.endswith("_locked"):
            continue
        for attr, kind, node, locked in _method_writes(m):
            if locked or attr not in guarded:
                continue
            what = ("assignment to" if kind == "LK01"
                    else "mutating operation on")
            out.append(Finding(
                rule=kind, severity=Severity.ERROR,
                path=mod.path, line=node.lineno,
                scope=f"{cls.name}.{m.name}",
                message=f"unlocked {what} guarded attribute "
                        f"self.{attr}: other methods write it under "
                        "the lock, so this write races them",
                hint="wrap in `with self._lock`, or rename the method "
                     "with a `_locked` suffix if callers hold the lock",
                detail=f"{attr}"))
    return out


def run(idx: ProjectIndex) -> List[Finding]:
    out: List[Finding] = []
    for mod in idx.modules:
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                out.extend(_check_class(mod, node))
    return out
