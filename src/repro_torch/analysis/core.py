"""Shared AST core: module scanning, name resolution, call graph, and
the hot-path closure.

The passes need one question answered well: *which function bodies run
once per block or once per token on the main paths?* The port has no
tracer to say so, so the entry points are named in one table,
``HOT_PATH_ROOTS``: module-name patterns mapped to the functions of
each module that are roots (or ``PUBLIC``: every public top-level
function). The hot path is the transitive call-graph reachability from
those roots, with calls resolved through import aliases
(``linucb.ucb_scores_batch`` ->
``repro_torch.core.linucb.ucb_scores_batch``); local defs inside a hot
function are hot too. Resolution is best-effort and conservative: an
unresolvable call (a method through ``self``, a backend picked at run
time) simply adds no edge, so passes err toward silence, not noise.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
from typing import Dict, List, Mapping, Optional, Sequence, Set, Tuple, Union

# Every public top-level function of the matching modules is a root.
PUBLIC = "public"

# The per-block and per-token entry points of the main paths: module-name
# pattern (fnmatch) -> root function (or "Class.method") names, or PUBLIC.
# A later slice that adds a hot entry point adds it here.
HOT_PATH_ROOTS: Dict[str, Union[str, Tuple[str, ...]]] = {
    # the router's block plane (core/router.py)
    "repro_torch.core.router": ("select_batch", "update_batch",
                                "step_batch"),
    # the backends select_batch / step_batch dispatch to through
    # get_backend(cfg), which the call graph cannot follow
    "repro_torch.core.backend": ("TorchBackend.score", "ScoreBackend.score",
                                 "FusedBackend.step_block"),
    # one served token and one prompt (models/transformer.py)
    "repro_torch.models.transformer": ("decode_step", "prefill"),
    # every kernel wrapper
    "repro_torch.kernels.*.ops": PUBLIC,
}

# Memoising decorators, as resolved through the module's imports.
CACHE_DECORATORS = ("functools.lru_cache", "functools.cache")


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` attribute chain -> "a.b.c"; None for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclasses.dataclass
class FunctionInfo:
    """One def/lambda: identity, AST, and its outgoing call edges."""

    qualname: str                 # module-local, e.g. "Cls.meth.<locals>.f"
    module: "ModuleInfo"
    node: ast.AST                 # FunctionDef | AsyncFunctionDef | Lambda
    parent: Optional["FunctionInfo"]
    decorators: Tuple[str, ...] = ()
    calls: Set[str] = dataclasses.field(default_factory=set)  # resolved

    @property
    def name(self) -> str:
        return getattr(self.node, "name", "<lambda>")

    @property
    def line(self) -> int:
        return self.node.lineno

    @property
    def global_qualname(self) -> str:
        return f"{self.module.modname}.{self.qualname}"

    def params(self) -> List[ast.arg]:
        a = self.node.args
        out = list(a.posonlyargs + a.args + a.kwonlyargs)
        out += [p for p in (a.vararg, a.kwarg) if p is not None]
        return out


@dataclasses.dataclass
class ModuleInfo:
    path: str                     # repo-relative posix path
    modname: str                  # dotted, e.g. "repro_torch.core.router"
    tree: ast.Module
    aliases: Dict[str, str]       # local name -> dotted origin
    functions: Dict[str, FunctionInfo]          # qualname -> info
    module_assigns: Dict[str, ast.AST]          # name -> value node
    module_defs: Set[str]         # top-level def / class names

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Resolve an expression to a dotted global name through the
        import aliases; local definitions resolve to module scope."""
        d = dotted(node)
        if d is None:
            return None
        head, _, rest = d.partition(".")
        origin = self.aliases.get(head)
        if origin is not None:
            return f"{origin}.{rest}" if rest else origin
        if head in self.module_defs or head in self.module_assigns:
            return f"{self.modname}.{d}"
        return d  # builtins / globals we didn't track


def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def unwrap_decorator(node: ast.AST) -> ast.AST:
    """``functools.lru_cache(maxsize=8)`` -> ``functools.lru_cache``;
    ``functools.partial(f, ...)`` -> ``f``."""
    if isinstance(node, ast.Call):
        name = dotted(node.func)
        if name in ("functools.partial", "partial") and node.args:
            return node.args[0]
        return node.func
    return node


class _Scanner(ast.NodeVisitor):
    """Single-module walk: builds FunctionInfos with call edges."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.stack: List[FunctionInfo] = []

    def _qual(self, name: str) -> str:
        if not self.stack:
            return name
        return f"{self.stack[-1].qualname}.<locals>.{name}"

    def _decorators(self, node) -> Tuple[str, ...]:
        decs = [self.mod.resolve(unwrap_decorator(d))
                for d in getattr(node, "decorator_list", ())]
        return tuple(d for d in decs if d)

    def _enter(self, node, qualname: str, parent):
        info = FunctionInfo(qualname=qualname, module=self.mod, node=node,
                            parent=parent, decorators=self._decorators(node))
        self.mod.functions[qualname] = info
        self.stack.append(info)
        return info

    def visit_ClassDef(self, node: ast.ClassDef):
        # methods get "Cls.meth" qualnames (classes sit at module scope)
        for child in node.body:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._enter(child, f"{node.name}.{child.name}", None)
                for stmt in child.body:
                    self.visit(stmt)
                self.stack.pop()
            else:
                self.visit(child)

    def _visit_function(self, node):
        self._enter(node, self._qual(node.name),
                    self.stack[-1] if self.stack else None)
        for stmt in node.body:
            self.visit(stmt)
        self.stack.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_Lambda(self, node: ast.Lambda):
        self._enter(node, self._qual(f"<lambda:{node.lineno}>"),
                    self.stack[-1] if self.stack else None)
        self.visit(node.body)
        self.stack.pop()

    def visit_Call(self, node: ast.Call):
        if self.stack:
            qn = (self._qual(node.func.id)
                  if isinstance(node.func, ast.Name) else None)
            if qn in self.mod.functions:
                # call through a local name: link to the sibling local def
                self.stack[-1].calls.add(f"{self.mod.modname}.{qn}")
            else:
                target = self.mod.resolve(node.func)
                if target:
                    self.stack[-1].calls.add(target)
        self.generic_visit(node)


def module_name(path: str) -> str:
    """Repo-relative path -> dotted module name (``src/`` dropped)."""
    modname = path[:-3].replace("/", ".")
    if modname.endswith(".__init__"):
        modname = modname[:-len(".__init__")]
    return modname[len("src."):] if modname.startswith("src.") else modname


def scan_module(path: str, repo_root: str) -> Optional[ModuleInfo]:
    with open(os.path.join(repo_root, path)) as fh:
        src = fh.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError:
        return None
    rel = path.replace(os.sep, "/")
    mod = ModuleInfo(path=rel, modname=module_name(rel), tree=tree,
                     aliases=_collect_aliases(tree), functions={},
                     module_assigns={}, module_defs={
                         n.name for n in tree.body if isinstance(n, (
                             ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef))})
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    mod.module_assigns[tgt.id] = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                mod.module_assigns[node.target.id] = node.value
    _Scanner(mod).visit(tree)
    return mod


@dataclasses.dataclass
class ProjectIndex:
    """All scanned modules + the hot-path closure."""

    repo_root: str
    modules: List[ModuleInfo]
    by_global: Dict[str, FunctionInfo]
    hot: Set[str]                 # global qualnames of hot functions
    hot_roots: Dict[str, str]     # qualname -> why it is an entry point

    def is_hot(self, info: FunctionInfo) -> bool:
        return info.global_qualname in self.hot


def _root_names(mod: ModuleInfo, roots: Mapping) -> Set[str]:
    out: Set[str] = set()
    for pattern, names in roots.items():
        if not fnmatch.fnmatchcase(mod.modname, pattern):
            continue
        if names == PUBLIC:
            out |= {qn for qn, info in mod.functions.items()
                    if "." not in qn and not qn.startswith(("_", "<"))}
        else:
            out |= {n for n in names if n in mod.functions}
    return out


def list_files(paths: Sequence[str], repo_root: str) -> List[str]:
    """Every .py file under ``paths`` (files or directories), repo-relative."""
    files: List[str] = []
    for p in paths:
        full = os.path.join(repo_root, p)
        if os.path.isfile(full) and p.endswith(".py"):
            files.append(p)
            continue
        for dirpath, _dirnames, filenames in os.walk(full):
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    files.append(os.path.relpath(
                        os.path.join(dirpath, fn), repo_root))
    return sorted(files)


def build_index(paths: Sequence[str], repo_root: str = ".",
                roots: Optional[Mapping] = None) -> ProjectIndex:
    """Scan every .py under ``paths`` and compute the hot closure from
    ``roots`` (default ``HOT_PATH_ROOTS``)."""
    roots = HOT_PATH_ROOTS if roots is None else roots
    modules = [m for m in (scan_module(f, repo_root)
                           for f in list_files(paths, repo_root))
               if m is not None]
    by_global: Dict[str, FunctionInfo] = {}
    for mod in modules:
        for info in mod.functions.values():
            by_global[info.global_qualname] = info

    hot_roots: Dict[str, str] = {}
    for mod in modules:
        for qn in sorted(_root_names(mod, roots)):
            hot_roots[mod.functions[qn].global_qualname] = (
                f"hot-path root of {mod.modname}")

    hot: Set[str] = set(hot_roots)
    work = list(hot_roots)
    while work:
        info = by_global.get(work.pop())
        if info is None:
            continue
        nested = [o.global_qualname for o in info.module.functions.values()
                  if o.parent is info]
        callees = [by_global[c].global_qualname for c in info.calls
                   if c in by_global]
        for qn in nested + callees:
            if qn not in hot:
                hot.add(qn)
                work.append(qn)

    return ProjectIndex(repo_root=repo_root, modules=modules,
                        by_global=by_global, hot=hot, hot_roots=hot_roots)


def is_cached(fn: FunctionInfo, enclosing: bool = True) -> bool:
    """Is this function (or, with ``enclosing``, one that encloses it)
    behind a memoising decorator (``functools.lru_cache`` / ``cache``)?"""
    f: Optional[FunctionInfo] = fn
    while f is not None:
        if any(d in CACHE_DECORATORS for d in f.decorators):
            return True
        f = f.parent if enclosing else None
    return False
