"""JB* — host syncs on the hot path.

A function on the per-block or per-token path (``core.HOT_PATH_ROOTS``
and what they call) that reads a device value back to the host stalls
the host until the device has caught up: one sync per block, or per
token, and the launches behind it go out one at a time.

  JB01  ``x.item()`` / ``x.tolist()`` / ``x.cpu()`` / ``x.numpy()`` on
        any value
  JB02  ``float(x)`` / ``int(x)`` / ``bool(x)`` on a tensor-tainted value
  JB03  ``np.asarray(x)`` / ``np.array(x)`` on a tensor-tainted value
  JB04  Python ``for`` iteration over a tensor-tainted value

Taint is intraprocedural and deliberately simple: a function's own
parameters (less the config and structure names, and those annotated
with a host type) and the results of ``torch.*`` calls are tainted;
taint flows through assignments. ``.shape`` / ``.dtype`` / ``.ndim`` /
``.device`` / ``len()`` and the tensor's other host metadata are host
values and never tainted. On the CPU none of these syncs costs
anything; on the card each is a wait.
"""
from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis.core import (
    FunctionInfo, ModuleInfo, ProjectIndex, dotted,
)
from repro_torch.analysis.findings import Finding, Severity

# Parameters that are configuration or structure in this codebase's
# idiom, never device tensors.
_STATIC_PARAMS = {
    "self", "cls", "cfg", "config", "statics", "spec", "env", "backend",
    "batch_size", "device", "dtype", "block_r",
}
# Parameter annotations of host values.
_HOST_ANNOTATIONS = {"int", "float", "bool", "str", "bytes", "dict",
                     "torch.device", "torch.dtype"}

_UNTAINT_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda"}
# Tensor methods that return host metadata.
_HOST_METHODS = {"size", "dim", "numel", "stride", "data_ptr",
                 "element_size", "is_contiguous", "get_device"}
_HOST_CALLS = {"len", "range", "isinstance", "hasattr", "getattr",
               "enumerate", "zip", "type", "min", "max", "divmod"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}


def _taint_set(fn: FunctionInfo) -> Set[str]:
    out = set()
    for p in fn.params():
        ann = dotted(p.annotation) if p.annotation is not None else None
        if p.arg not in _STATIC_PARAMS and ann not in _HOST_ANNOTATIONS:
            out.add(p.arg)
    return out


def _expr_tainted(node: ast.AST, tainted: Set[str],
                  mod: ModuleInfo) -> bool:
    """Best-effort: does this expression carry a device tensor?"""
    if isinstance(node, ast.Name):
        return node.id in tainted
    if isinstance(node, ast.Attribute):
        if node.attr in _UNTAINT_ATTRS:
            return False
        return _expr_tainted(node.value, tainted, mod)
    if isinstance(node, ast.Subscript):
        return _expr_tainted(node.value, tainted, mod)
    if isinstance(node, ast.Call):
        name = mod.resolve(node.func) or ""
        if dotted(node.func) in _HOST_CALLS:
            return False
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _HOST_METHODS:
            return False
        if name.startswith("torch."):
            return True
        # method calls on tainted receivers stay tainted (x.sum() ...)
        if isinstance(node.func, ast.Attribute):
            return _expr_tainted(node.func.value, tainted, mod)
        return any(_expr_tainted(a, tainted, mod) for a in node.args)
    if isinstance(node, ast.BinOp):
        return (_expr_tainted(node.left, tainted, mod)
                or _expr_tainted(node.right, tainted, mod))
    if isinstance(node, ast.UnaryOp):
        return _expr_tainted(node.operand, tainted, mod)
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(_expr_tainted(e, tainted, mod) for e in node.elts)
    if isinstance(node, ast.IfExp):
        return (_expr_tainted(node.body, tainted, mod)
                or _expr_tainted(node.orelse, tainted, mod))
    if isinstance(node, ast.Starred):
        return _expr_tainted(node.value, tainted, mod)
    return False


def _body(fn: FunctionInfo) -> List[ast.AST]:
    return fn.node.body if isinstance(fn.node.body, list) else [fn.node.body]


def _propagate(fn: FunctionInfo, mod: ModuleInfo) -> Set[str]:
    """One forward sweep of taint through assignments (iterated to a
    small fixed point for loop-carried names)."""
    tainted = _taint_set(fn)
    for _ in range(3):
        before = len(tainted)
        for node in ast.walk(ast.Module(body=_body(fn), type_ignores=[])):
            if isinstance(node, ast.Assign):
                if _expr_tainted(node.value, tainted, mod):
                    for tgt in node.targets:
                        for n in ast.walk(tgt):
                            if isinstance(n, ast.Name):
                                tainted.add(n.id)
            elif isinstance(node, ast.AugAssign):
                if (_expr_tainted(node.value, tainted, mod)
                        and isinstance(node.target, ast.Name)):
                    tainted.add(node.target.id)
        if len(tainted) == before:
            break
    return tainted


_NESTED = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda, ast.ClassDef)


def _is_sync_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS and not node.args)


def _finding(rule, mod, node, fn, message, hint, detail):
    return Finding(rule=rule, severity=Severity.ERROR, path=mod.path,
                   line=node.lineno, scope=fn.qualname, message=message,
                   hint=hint, detail=detail[:80])


def _check_fn(mod: ModuleInfo, fn: FunctionInfo) -> List[Finding]:
    out: List[Finding] = []
    tainted = _propagate(fn, mod)

    def visit(node):
        if isinstance(node, ast.Call):
            if _is_sync_call(node):
                if _is_sync_call(node.func.value):
                    return            # x.cpu().numpy(): one sync, flagged once
                out.append(_finding(
                    "JB01", mod, node, fn,
                    f".{node.func.attr}() on the hot path copies to the "
                    "host and waits for the device",
                    "keep the value on the device; read it out once, "
                    "after the block or the request",
                    ast.unparse(node.func)))
                return
            fname = dotted(node.func)
            if fname in ("float", "int", "bool") and len(node.args) == 1:
                if _expr_tainted(node.args[0], tainted, mod):
                    out.append(_finding(
                        "JB02", mod, node, fn,
                        f"{fname}() of a tensor on the hot path is a "
                        "device->host sync",
                        "use torch ops on the tensor, or hoist the "
                        "conversion off the per-block path",
                        ast.unparse(node)))
                return
            cname = mod.resolve(node.func)
            if cname in ("numpy.asarray", "numpy.array") and node.args:
                if _expr_tainted(node.args[0], tainted, mod):
                    out.append(_finding(
                        "JB03", mod, node, fn,
                        "np.asarray of a tensor on the hot path copies it "
                        "to the host and waits for the device",
                        "keep it a tensor, or move the readout off the "
                        "per-block path",
                        ast.unparse(node)))
        elif isinstance(node, ast.For):
            it = node.iter
            if isinstance(it, (ast.Name, ast.Attribute)) and \
                    _expr_tainted(it, tainted, mod):
                out.append(_finding(
                    "JB04", mod, node, fn,
                    "Python iteration over a tensor on the hot path reads "
                    "it element by element (a sync each)",
                    "vectorise with torch ops, or iterate a host length",
                    ast.unparse(it)))

    def walk(node):
        # nested defs/lambdas are checked as their own functions
        if isinstance(node, _NESTED):
            return
        visit(node)
        for child in ast.iter_child_nodes(node):
            walk(child)

    for stmt in _body(fn):
        walk(stmt)
    return out


def run(idx: ProjectIndex) -> List[Finding]:
    out: List[Finding] = []
    for mod in idx.modules:
        for fn in mod.functions.values():
            if idx.is_hot(fn):
                out.extend(_check_fn(mod, fn))
    return out
