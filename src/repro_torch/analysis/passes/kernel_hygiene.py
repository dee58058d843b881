"""KW* — kernel-wrapper hygiene.

A kernel wrapper (``kernels/*/ops.py``) runs the plain version on CPU
tensors and, on CUDA tensors, checks the operands and launches the
hand-written kernel, or raises. Three ways to break that contract are
visible in the source:

  KW01  a call into the kernel module's launch (a ``kernel.py`` function
        that reaches ``build.library()``) from a wrapper function with
        no ``checks.*_operands`` call on its path: neither it nor every
        in-module caller checks the operands, so a wrong shape, dtype or
        device reaches the kernel as raw pointers. The port's kernels
        mask ragged tiles and do not pad, so this takes the place of the
        JAX suite's padding rule (PL03).
  KW02  a ``try``/``except`` around a launch whose handler falls back to
        the plain ``ref`` version or does not re-raise, or a branch on
        ``torch.cuda.is_available()`` that runs the ``ref`` version: a
        fallback that hides the kernel, so a failed build or launch
        passes as a slow success.
  KW03  a ``build.library().*_launch(...)`` whose returned error code is
        not checked: the result is not bound to a name that an ``if``
        tests before raising, so a failed launch goes unnoticed.

The JAX suite's PL01 and PL02 concern Pallas captures and aliases and
have no meaning here.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional

from repro_torch.analysis.core import FunctionInfo, ModuleInfo, ProjectIndex
from repro_torch.analysis.findings import Finding, Severity


def _is_wrapper_module(mod: ModuleInfo) -> bool:
    return "/kernels/" in f"/{mod.path}" and mod.path.endswith("/ops.py")


def _calls(node: ast.AST):
    return (n for n in ast.walk(node) if isinstance(n, ast.Call))


_NESTED = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _own_nodes(fn: FunctionInfo):
    """Every node of ``fn``'s body, not descending into nested defs (each
    is checked as its own function)."""
    body = fn.node.body if isinstance(fn.node.body, list) else [fn.node.body]
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, _NESTED):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _is_library_call(node: ast.AST, mod: ModuleInfo) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = mod.resolve(node.func) or ""
    return name == "library" or name.endswith(".library")


def _reaches_library(info: FunctionInfo) -> bool:
    return any(_is_library_call(c, info.module) for c in _calls(info.node))


class _Wrapper:
    """One ``ops.py``: its launches, checks and ``ref`` calls."""

    def __init__(self, idx: ProjectIndex, mod: ModuleInfo):
        self.idx, self.mod = idx, mod
        pkg = mod.modname.rsplit(".", 1)[0]
        self.kernel_mod, self.ref_mod = pkg + ".kernel.", pkg + ".ref."
        self._reach: Dict[str, bool] = {}

    def is_launch(self, target: str) -> bool:
        if not target.startswith(self.kernel_mod):
            return False
        info = self.idx.by_global.get(target)
        return info is None or _reaches_library(info)

    def is_ref(self, target: Optional[str]) -> bool:
        return bool(target) and target.startswith(self.ref_mod)

    def launches(self, fn: FunctionInfo) -> List[str]:
        return sorted(c for c in fn.calls if self.is_launch(c))

    def reaches_launch(self, target: str, seen=()) -> bool:
        """Does this in-module function launch, directly or through other
        functions of the module?"""
        info = self.mod.functions.get(target[len(self.mod.modname) + 1:])
        if info is None or target in seen:
            return self.is_launch(target)
        if target not in self._reach:
            self._reach[target] = bool(self.launches(info)) or any(
                self.reaches_launch(c, seen + (target,)) for c in info.calls
                if c.startswith(self.mod.modname + "."))
        return self._reach[target]

    def call_reaches_launch(self, call: ast.Call) -> bool:
        target = self.mod.resolve(call.func)
        return bool(target) and (self.is_launch(target)
                                 or self.reaches_launch(target))

    def checks(self, fn: FunctionInfo) -> bool:
        return any((c.rsplit(".", 1)[-1].endswith("_operands")
                    and ".checks." in f".{c}") for c in fn.calls)

    def checked(self, fn: FunctionInfo, seen=()) -> bool:
        """Checks on every path into ``fn``: it checks, or it has callers
        in the module and every one of them is checked."""
        if self.checks(fn):
            return True
        if fn.qualname in seen:
            return False
        callers = [g for g in self.mod.functions.values()
                   if fn.global_qualname in g.calls or (
                       fn.parent is g)]
        return bool(callers) and all(
            self.checked(g, seen + (fn.qualname,)) for g in callers)

    def calls_ref(self, nodes) -> bool:
        return any(self.is_ref(self.mod.resolve(c.func))
                   for n in nodes for c in _calls(n))


def _kw01(w: _Wrapper) -> List[Finding]:
    out = []
    for fn in w.mod.functions.values():
        for target in w.launches(fn):
            if w.checked(fn):
                continue
            out.append(Finding(
                rule="KW01", severity=Severity.ERROR, path=w.mod.path,
                line=fn.line, scope=fn.qualname,
                message=f"launch {target.rsplit('.', 1)[-1]}() with no "
                        "checks.*_operands on its path: a wrong shape, "
                        "dtype or device reaches the kernel as raw "
                        "pointers",
                hint="call checks.cuda_operands (or the kernel family's "
                     "*_operands check) before the launch",
                detail=f"unchecked:{target.rsplit('.', 1)[-1]}"))
    return out


def _handler_hides(w: _Wrapper, handler: ast.ExceptHandler) -> bool:
    reraises = any(isinstance(n, ast.Raise) for n in ast.walk(handler))
    return w.calls_ref(handler.body) or not reraises


def _is_available(node: ast.AST, mod: ModuleInfo) -> bool:
    return any(mod.resolve(c.func) == "torch.cuda.is_available"
               for c in _calls(node))


def _kw02(w: _Wrapper) -> List[Finding]:
    out = []
    for fn in w.mod.functions.values():
        for node in _own_nodes(fn):
            if isinstance(node, ast.Try):
                launch = any(w.call_reaches_launch(c)
                             for s in node.body for c in _calls(s))
                if launch and any(_handler_hides(w, h)
                                  for h in node.handlers):
                    out.append(_kw02_finding(
                        w, fn, node, "try/except around the launch "
                        "swallows its failure or falls back to the plain "
                        "version", "try"))
            elif isinstance(node, ast.If) and _is_available(node.test, w.mod):
                if w.calls_ref(node.body + node.orelse):
                    out.append(_kw02_finding(
                        w, fn, node, "a branch on torch.cuda.is_available() "
                        "runs the plain version in place of the kernel",
                        "is_available"))
    return out


def _kw02_finding(w, fn, node, what, detail):
    return Finding(
        rule="KW02", severity=Severity.ERROR, path=w.mod.path,
        line=node.lineno, scope=fn.qualname,
        message=f"{what}: a failed build or launch passes as a slow "
                "success",
        hint="choose the route by the operands' device (checks.on_cpu) "
             "and let a failed launch raise",
        detail=detail)


def _kw03(mod: ModuleInfo) -> List[Finding]:
    out = []
    for fn in mod.functions.values():
        nodes = list(_own_nodes(fn))
        libs, bound, tested, direct = set(), {}, set(), set()
        for n in nodes:
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                bound[id(n.value)] = n.targets[0].id
                if _is_library_call(n.value, mod):
                    libs.add(n.targets[0].id)
            elif isinstance(n, ast.If) and any(
                    isinstance(r, ast.Raise) for s in n.body
                    for r in ast.walk(s)):
                tested |= {x.id for x in ast.walk(n.test)
                           if isinstance(x, ast.Name)}
                direct |= {id(c) for c in _calls(n.test)}
        for call in nodes:
            if not isinstance(call, ast.Call):
                continue
            f = call.func
            if not (isinstance(f, ast.Attribute)
                    and f.attr.endswith("_launch")):
                continue
            recv = f.value
            if not (_is_library_call(recv, mod) or (
                    isinstance(recv, ast.Name) and recv.id in libs)):
                continue
            if id(call) in direct or bound.get(id(call)) in tested:
                continue
            out.append(Finding(
                rule="KW03", severity=Severity.ERROR, path=mod.path,
                line=call.lineno, scope=fn.qualname,
                message=f"{f.attr}() returns a CUDA error code that is "
                        "never checked: a failed launch goes unnoticed",
                hint="err = ...; if err: raise RuntimeError(...)",
                detail=f"unchecked:{f.attr}"))
    return out


def run(idx: ProjectIndex) -> List[Finding]:
    out: List[Finding] = []
    for mod in idx.modules:
        if _is_wrapper_module(mod):
            w = _Wrapper(idx, mod)
            out.extend(_kw01(w))
            out.extend(_kw02(w))
        out.extend(_kw03(mod))
    return out
