"""Shared infrastructure of the port's repro-lint passes — a copy of
``repro.analysis.common`` with two additions for the port.

Everything here is stdlib-only (``ast`` + ``tokenize``): the lint runs
without torch or numpy installed, so no module in
``repro_torch.analysis`` may import anything outside the standard library
and this package (a meta-test in tests/test_torch_analysis.py asserts
this by scanning our own imports).

The pieces, as in the reference:

  * ``Finding`` — one structured diagnostic (file:line, rule id, rule
    name, message), the unit every pass emits and the baseline stores;
  * ``SourceFile`` — a parsed module with parent-annotated AST, the
    import alias map (``qualname`` resolves ``dist.all_reduce`` →
    ``torch.distributed.all_reduce``), and the suppression table parsed
    from ``# repro-lint: disable=RULE(reason)`` comments;
  * scope helpers — ``enclosing_function``, ``resolve_local_def``.

Added for the port:

  * ``def_qualname``/``SourceFile.defs`` — every ``def`` by its dotted
    path (``PrioritizedReplay.flush``, ``make_step.step``);
  * ``package_module``/``package_files`` — the port's own modules by
    their path under ``src/repro_torch`` (``core/replay.py``), parsed
    once a process, which the registry and the in-place table resolve
    against, and ``resolve_call``, the def a call names statically.

Suppression semantics are the reference's: a disable comment applies to
findings on its own line; a *standalone* comment line applies to the
next statement line; a comment on a ``def``/``class`` line applies to
the whole body.  A disable with an empty reason is itself reported (rule
X001) — every waiver must say why.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Set, Tuple

# rule id → human name; every pass registers its rules here so the CLI
# and the docs enumerate one table
RULES: Dict[str, str] = {
    "X000": "parse-error",
    "X001": "bad-suppression",
}


def register_rules(rules: Dict[str, str]) -> None:
    RULES.update(rules)


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    file: str          # repo-relative posix path
    line: int
    rule: str          # e.g. "D101"
    message: str

    @property
    def name(self) -> str:
        return RULES.get(self.rule, "unknown-rule")

    def render(self) -> str:
        return f"{self.file}:{self.line}: {self.rule} [{self.name}] {self.message}"

    def to_json(self) -> dict:
        return {"file": self.file, "line": self.line, "rule": self.rule,
                "name": self.name, "message": self.message}


_DISABLE_RE = re.compile(
    r"repro-lint:\s*disable=((?:[A-Z]\d{3}\([^()]*\)(?:\s*,\s*)?)+)")
_RULE_RE = re.compile(r"([A-Z]\d{3})\(([^()]*)\)")


def attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._rl_parent = node  # type: ignore[attr-defined]


def ancestors(node: ast.AST) -> Iterable[ast.AST]:
    node = getattr(node, "_rl_parent", None)
    while node is not None:
        yield node
        node = getattr(node, "_rl_parent", None)


FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    for anc in ancestors(node):
        if isinstance(anc, FunctionNode):
            return anc
    return None


def collect_aliases(tree: ast.AST) -> Dict[str, str]:
    """Imported-name → fully dotted target, so ``qualname`` can resolve
    ``dist.all_reduce`` → ``torch.distributed.all_reduce`` and ``adam``
    → ``repro_torch.optim.adam``."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    aliases[root] = root
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def qualname(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Dotted name of a Name/Attribute chain with the import alias map
    applied to the root; None for anything dynamic (calls, subscripts)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(aliases.get(node.id, node.id))
        return ".".join(reversed(parts))
    return None


def resolve_local_def(name: str, at: ast.AST) -> Optional[ast.AST]:
    """The lexically visible ``def name`` for a reference at ``at`` —
    walk enclosing scopes innermost-out and take the first match."""
    scopes = [a for a in ancestors(at)
              if isinstance(a, FunctionNode + (ast.Module, ast.ClassDef))]
    for scope in scopes:
        body = getattr(scope, "body", [])
        for stmt in body if isinstance(body, list) else []:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name == name:
                return stmt
    return None


def positional_params(fn: ast.AST) -> List[str]:
    a = fn.args
    return [p.arg for p in list(a.posonlyargs) + list(a.args)]


def const_int_tuple(node: ast.AST) -> Optional[Tuple[int, ...]]:
    """Literal int / tuple-or-list of ints, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for el in node.elts:
            if not (isinstance(el, ast.Constant) and isinstance(el.value, int)):
                return None
            out.append(el.value)
        return tuple(out)
    return None


def def_qualname(node: ast.AST) -> str:
    """Dotted path of a ``def`` through its enclosing classes and defs:
    ``PrioritizedReplay.flush``, ``make_step.step``."""
    parts = [node.name]
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            parts.append(anc.name)
    return ".".join(reversed(parts))


class SourceFile:
    """One parsed module plus everything the passes share: alias map,
    parent links, suppression table."""

    def __init__(self, path: str, relpath: str, text: Optional[str] = None):
        self.path = path
        self.relpath = relpath
        if text is None:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        self.text = text
        self.parse_error: Optional[Finding] = None
        self.bad_suppressions: List[Finding] = []
        try:
            self.tree: ast.AST = ast.parse(text, filename=relpath)
        except SyntaxError as e:
            self.tree = ast.Module(body=[], type_ignores=[])
            self.parse_error = Finding(relpath, e.lineno or 1, "X000",
                                       f"cannot parse: {e.msg}")
        attach_parents(self.tree)
        self.aliases = collect_aliases(self.tree)
        self._suppressions = self._parse_suppressions()
        self._defs: Optional[Dict[str, ast.AST]] = None
        self._func_lines = sorted(
            (node.lineno, max(getattr(node, "end_lineno", node.lineno),
                              node.lineno))
            for node in ast.walk(self.tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)))

    # -- suppressions -------------------------------------------------------

    def _parse_suppressions(self) -> Dict[int, Set[str]]:
        supp: Dict[int, Set[str]] = {}
        standalone: List[Tuple[int, Set[str]]] = []
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return supp
        code_lines = {t.start[0] for t in tokens
                      if t.type not in (tokenize.COMMENT, tokenize.NL,
                                        tokenize.NEWLINE, tokenize.INDENT,
                                        tokenize.DEDENT, tokenize.ENDMARKER)}
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _DISABLE_RE.search(tok.string)
            if m is None:
                if "repro-lint:" in tok.string:
                    self.bad_suppressions.append(Finding(
                        self.relpath, tok.start[0], "X001",
                        "malformed repro-lint comment: expected "
                        "'# repro-lint: disable=RULE(reason)'"))
                continue
            rules = set()
            for rule, reason in _RULE_RE.findall(m.group(1)):
                if not reason.strip():
                    self.bad_suppressions.append(Finding(
                        self.relpath, tok.start[0], "X001",
                        f"suppression of {rule} has no reason — every "
                        "waiver must say why"))
                    continue
                rules.add(rule)
            if not rules:
                continue
            line = tok.start[0]
            if line in code_lines:
                supp.setdefault(line, set()).update(rules)
            else:
                standalone.append((line, rules))
        # a standalone comment applies to the next code line
        for line, rules in standalone:
            nxt = min((c for c in code_lines if c > line), default=None)
            if nxt is not None:
                supp.setdefault(nxt, set()).update(rules)
        return supp

    def is_suppressed(self, finding: Finding) -> bool:
        rules = self._suppressions.get(finding.line)
        if rules and finding.rule in rules:
            return True
        # def-line suppressions cover the whole function body
        for start, end in self._func_lines:
            if start <= finding.line <= end:
                rules = self._suppressions.get(start)
                if rules and finding.rule in rules:
                    return True
        return False

    # -- helpers shared by passes ------------------------------------------

    def qualname(self, node: ast.AST) -> Optional[str]:
        return qualname(node, self.aliases)

    def finding(self, node: ast.AST, rule: str, message: str) -> Finding:
        return Finding(self.relpath, getattr(node, "lineno", 1), rule, message)

    @property
    def defs(self) -> Dict[str, ast.AST]:
        """Every ``def`` of the module by ``def_qualname`` (the first of
        two that share a path)."""
        if self._defs is None:
            self._defs = {}
            for node in ast.walk(self.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._defs.setdefault(def_qualname(node), node)
        return self._defs

    @property
    def module(self) -> Optional[str]:
        return package_module(self.relpath)


# -- the port's own modules ---------------------------------------------------

# src/repro_torch: the package this lint belongs to and checks
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "repro_torch"

_PACKAGE_FILES: Dict[str, Dict[str, SourceFile]] = {}


def package_module(relpath: str) -> Optional[str]:
    """``core/replay.py`` for any path that ends in
    ``repro_torch/core/replay.py``; None outside the package."""
    parts = relpath.replace(os.sep, "/").split("/")
    if PACKAGE not in parts[:-1]:
        return None
    i = len(parts) - 1 - parts[::-1].index(PACKAGE)
    return "/".join(parts[i + 1:])


def module_path(dotted: str) -> Optional[str]:
    """``repro_torch.core.replay`` → ``core/replay.py`` (a package's
    ``__init__.py`` for a package); None outside the port."""
    parts = dotted.split(".")
    if parts[0] != PACKAGE or len(parts) < 2:
        return None
    return "/".join(parts[1:]) + ".py"


def package_files(package_dir: str = PACKAGE_DIR) -> Dict[str, SourceFile]:
    """Every module of the port by ``package_module`` path, parsed once a
    process (the registry and the in-place table resolve against it)."""
    files = _PACKAGE_FILES.get(package_dir)
    if files is None:
        files = {}
        for dirpath, dirnames, filenames in os.walk(package_dir):
            dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
            for name in sorted(filenames):
                if name.endswith(".py"):
                    path = os.path.join(dirpath, name)
                    rel = os.path.relpath(path, package_dir).replace(os.sep, "/")
                    files[rel] = SourceFile(path, f"{PACKAGE}/{rel}")
        _PACKAGE_FILES[package_dir] = files
    return files


def resolve_call(sf: SourceFile, call: ast.Call,
                 files: Dict[str, SourceFile]) -> Optional[Tuple[str, str]]:
    """(module, def qualname) of a call that resolves statically: a def
    lexically visible from the call, a method of the enclosing class
    through ``self``, or a def of a port module the file imports; None
    for anything dynamic."""
    func = call.func
    if isinstance(func, ast.Name):
        target = resolve_local_def(func.id, call)
        if target is not None:
            return sf.module or "", def_qualname(target)
    elif isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name) \
            and func.value.id == "self":
        cls = next((a for a in ancestors(call) if isinstance(a, ast.ClassDef)), None)
        if cls is not None:
            for stmt in cls.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and stmt.name == func.attr:
                    return sf.module or "", def_qualname(stmt)
        return None
    qn = sf.qualname(func)
    if qn is None or not qn.startswith(PACKAGE + "."):
        return None
    parts = qn.split(".")
    for cut in range(len(parts) - 1, 0, -1):
        mod = module_path(".".join(parts[:cut]))
        for cand in (mod, mod and mod[:-3] + "/__init__.py"):
            if cand in files and ".".join(parts[cut:]) in files[cand].defs:
                return cand, ".".join(parts[cut:])
    return None
