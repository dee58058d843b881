"""RT* — capture and compile hazards.

The port has no tracer, but two of its tools cost a capture or a
compile when they are made, and one cache can never hit:

  RT01  a ``torch.cuda.CUDAGraph`` or ``torch.compile`` created *and
        invoked* inside a plain function: every call of the enclosing
        function captures (or compiles) from scratch. Accepted: module
        level; an ``lru_cache``/``cache``-decorated factory (or a
        function inside one); returning the object, or storing it into
        a cache subscript or a ``self`` attribute.
  RT03  a ``functools.lru_cache`` / ``cache`` over a function with a
        parameter annotated ``Tensor``: the cache keys on the tensor's
        identity, so it never hits, and it keeps every tensor alive.

The JAX suite's RT02, a closure capturing an array into a compiled
program, has no torch meaning.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from repro_torch.analysis.core import (
    FunctionInfo, ModuleInfo, ProjectIndex, dotted, is_cached,
)
from repro_torch.analysis.findings import Finding, Severity

_MAKERS = {"torch.cuda.CUDAGraph": "graph", "torch.compile": "compile"}
_MAKER_NAMES = {kind: name for name, kind in _MAKERS.items()}
_TENSOR_ANNOTATIONS = {"Tensor", "torch.Tensor"}


def _assigned_name(node: ast.Call, body: ast.Module) -> Optional[str]:
    for n in ast.walk(body):
        if isinstance(n, ast.Assign) and n.value is node:
            for tgt in n.targets:
                if isinstance(tgt, ast.Name):
                    return tgt.id
    return None


def _refers(n: ast.AST, node: ast.Call, name: Optional[str]) -> bool:
    return n is node or (name is not None and isinstance(n, ast.Name)
                         and n.id == name)


def _escapes(node: ast.Call, body: ast.Module, name: Optional[str]) -> bool:
    """Returned, stored into a subscript cache, or set on an attribute."""
    for n in ast.walk(body):
        if isinstance(n, ast.Return) and n.value is not None \
                and _refers(n.value, node, name):
            return True
        if isinstance(n, ast.Assign) and _refers(n.value, node, name):
            if any(isinstance(t, (ast.Subscript, ast.Attribute))
                   for t in n.targets):
                return True
    return False


def _is_invoked(kind: str, node: ast.Call, body: ast.Module,
                name: Optional[str]) -> bool:
    """A graph is invoked by ``.replay()``; a compiled callable by a
    call."""
    for n in ast.walk(body):
        if not isinstance(n, ast.Call):
            continue
        if kind == "graph":
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "replay" \
                    and _refers(n.func.value, node, name):
                return True
        elif _refers(n.func, node, name):
            return True
    return False


def _check_rt01(mod: ModuleInfo, node: ast.Call, kind: str,
                scope: FunctionInfo) -> List[Finding]:
    if is_cached(scope):
        return []
    body = ast.Module(body=scope.node.body if isinstance(
        scope.node.body, list) else [ast.Expr(scope.node.body)],
        type_ignores=[])
    name = _assigned_name(node, body)
    if _escapes(node, body, name) or not _is_invoked(kind, node, body, name):
        return []
    what = ("a CUDA graph is captured" if kind == "graph"
            else "torch.compile compiles")
    return [Finding(
        rule="RT01", severity=Severity.WARNING, path=mod.path,
        line=node.lineno, scope=scope.qualname,
        message=f"{_MAKER_NAMES[kind]} created and invoked inside a plain "
                f"function: {what} anew on every call of the enclosing "
                "function",
        hint="build it once behind functools.lru_cache, or keep it on "
             "the object that replays it",
        detail=f"{kind}:{name or 'anon'}")]


def _check_rt03(mod: ModuleInfo, fn: FunctionInfo) -> List[Finding]:
    if not is_cached(fn, enclosing=False):
        return []
    out = []
    for p in fn.params():
        if p.annotation is not None and \
                (dotted(p.annotation) or "") in _TENSOR_ANNOTATIONS:
            out.append(Finding(
                rule="RT03", severity=Severity.ERROR, path=mod.path,
                line=fn.line, scope=fn.qualname,
                message=f"cached function takes tensor {p.arg!r}: the "
                        "cache keys on its identity, never hits, and "
                        "keeps every tensor it saw alive",
                hint="key the cache on shapes and host values, and pass "
                     "the tensor to the cached product",
                detail=f"cache:{p.arg}"))
    return out


def _check_module(mod: ModuleInfo) -> List[Finding]:
    out: List[Finding] = []
    info_of = {info.node: info for info in mod.functions.values()}

    class _V(ast.NodeVisitor):
        def __init__(self):
            self.stack: List[FunctionInfo] = []

        def _fn(self, node):
            info = info_of.get(node)
            if info:
                self.stack.append(info)
            self.generic_visit(node)
            if info:
                self.stack.pop()

        visit_FunctionDef = _fn
        visit_AsyncFunctionDef = _fn
        visit_Lambda = _fn

        def visit_Call(self, node: ast.Call):
            kind = _MAKERS.get(mod.resolve(node.func) or "")
            if kind and self.stack:
                out.extend(_check_rt01(mod, node, kind, self.stack[-1]))
            self.generic_visit(node)

    _V().visit(mod.tree)
    for fn in mod.functions.values():
        out.extend(_check_rt03(mod, fn))
    return out


def run(idx: ProjectIndex) -> List[Finding]:
    out: List[Finding] = []
    for mod in idx.modules:
        out.extend(_check_module(mod))
    return out
