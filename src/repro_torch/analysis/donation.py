"""Pass 1 — in-place safety (rules D101/D102), the port's counterpart of
``repro.analysis.donation``.

The reference donates its replay state, its decode cache and its train
state at six ``donate_argnums`` sites; reading a donated binding after
the call raises there (``Array has been deleted``).  The port updates the
same buffers **in place** (``core/replay.py``: each op returns a state
that shares its tensors with the one passed in; ``serve/engine.py``: one
live KV cache; ``agents/token_dqn.py``: the train state), so a read of
the old binding silently returns the new data.  ``IN_PLACE`` below lists
those functions: each entry names the function, the argument it updates
(and the field of it, where only one is: the loop step updates
``state.replay``), and the reference's donation site it stands for.

  * **D101 use-after-update** — for every call that matches an entry
    (by the callee's name and its positional arity, or the argument
    passed by keyword), any read of the expression passed at the updated
    argument after the call and before the binding is rebound is
    flagged.  Tracked bindings are plain names and dotted paths
    (``state.replay``); reads of a sub-path count too; a read earlier in
    a loop body that does not rebind counts as after.  An expression
    that is not a binding (``state.clone()``, a subscript) is not
    tracked: a ``.clone()`` taken before the call keeps the old state
    readable, and reading the clone is not a read of the binding.
  * **D102 table-drift** — an entry whose argument is not in the named
    function's signature at its position, or whose function is gone
    (reported in the entry's module, where the signature drifted): the
    drift that D102 catches for ``donate_argnums``.

The reference's two dry-run sites lower on abstract shapes; the port's
dry run runs on the meta device, where nothing is stored
(``NO_COUNTERPART``).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.common import (Finding, SourceFile, ancestors,
                                         enclosing_function, package_files,
                                         positional_params, register_rules)

register_rules({
    "D101": "inplace-use-after-update",
    "D102": "inplace-table-drift",
})

Path = Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class InPlace:
    module: str     # under src/repro_torch, e.g. "core/replay.py"
    func: str       # the def's dotted path, e.g. "PrioritizedReplay.flush"
    arg: str        # the parameter updated in place
    pos: int        # its index among the call's positional arguments (no self)
    site: str       # the reference's donate_argnums site it stands for
    field: str = ""     # the attribute of ``arg`` updated, where only one is
    note: str = ""


@dataclasses.dataclass(frozen=True)
class NoCounterpart:
    site: str
    reason: str


_CHUNK = "runtime/executors.py:198"           # FusedExecutor's chunk: replay state
_SHARDED_CHUNK = "runtime/executors.py:426"   # ShardedExecutor's chunk
_DECODE = "serve/engine.py:124"               # DecodeEngine's step: the cache
_TRAIN = "launch/train.py:254"                # the token-DQN train step

IN_PLACE: Tuple[InPlace, ...] = (
    InPlace("core/replay.py", "PrioritizedReplay.insert_begin", "state", 0, _CHUNK),
    InPlace("core/replay.py", "PrioritizedReplay.insert_commit", "state", 0, _CHUNK),
    InPlace("core/replay.py", "PrioritizedReplay.append", "state", 0, _CHUNK),
    InPlace("core/replay.py", "PrioritizedReplay.flush", "state", 0, _CHUNK),
    InPlace("core/replay.py", "PrioritizedReplay.update_priorities", "state", 0, _CHUNK),
    InPlace("runtime/loop.py", "make_step.step", "state", 0, _CHUNK, field="replay",
            note="the composed step runs the replay ops above on state.replay"),
    InPlace("runtime/executors.py", "Executor.run_chunk", "state", 0, _CHUNK,
            field="replay"),
    InPlace("runtime/executors.py", "ShardedExecutor.run_chunk", "state", 0,
            _SHARDED_CHUNK, field="replay"),
    InPlace("runtime/executors.py", "AsyncExecutor.run_chunk", "state", 0, _CHUNK,
            field="replay"),
    InPlace("serve/engine.py", "DecodeEngine.step", "state", 1, _DECODE),
    InPlace("serve/engine.py", "DecodeEngine.insert", "state", 0, _DECODE,
            note="the reference's insert copies; the port writes the one live cache"),
    InPlace("serve/engine.py", "DecodeEngine.release", "state", 0, _DECODE,
            note="the reference's release copies; the port writes the one live cache"),
    InPlace("agents/token_dqn.py", "train_step", "state", 3, _TRAIN),
)

NO_COUNTERPART: Tuple[NoCounterpart, ...] = (
    NoCounterpart("launch/dryrun.py:181",
                  "the port's dry run runs the train step on the meta device: "
                  "no storage to update or donate"),
    NoCounterpart("launch/dryrun.py:233",
                  "the port's dry run runs the decode step on the meta device: "
                  "no storage to update or donate"),
)


def _expr_path(node: ast.AST) -> Optional[Path]:
    """("state", "replay") for ``state.replay``; None for anything
    dynamic (calls, subscripts, literals)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _signature(entry: InPlace) -> Optional[Tuple[List[str], int, bool]]:
    """(positional params without self, how many are required, *args?)
    of the entry's def in the package; None if it is gone."""
    sf = package_files().get(entry.module)
    fn = sf.defs.get(entry.func) if sf is not None else None
    if fn is None:
        return None
    params = positional_params(fn)
    n_defaults = len(fn.args.defaults)
    if "." in entry.func and params and params[0] in ("self", "cls"):
        params = params[1:]
    return params, len(params) - n_defaults, fn.args.vararg is not None


def _updated_arg(call: ast.Call, by_name: Dict[str, List[InPlace]]
                 ) -> List[Tuple[InPlace, ast.AST]]:
    """(entry, expression passed at its updated argument) for each entry
    the call matches: by the callee's name, and by its positional arity
    or the argument passed by keyword."""
    func = call.func
    name = func.attr if isinstance(func, ast.Attribute) else \
        func.id if isinstance(func, ast.Name) else None
    out = []
    if any(isinstance(a, ast.Starred) for a in call.args):
        return out
    for entry in by_name.get(name or "", ()):
        sig = _signature(entry)
        if sig is None:
            continue
        params, required, vararg = sig
        keywords = {kw.arg for kw in call.keywords}
        if None in keywords:
            continue
        n = len(call.args)
        bound = params[:n]
        if n > len(params) and not vararg:
            continue
        if required > n + len(keywords & set(params[n:required])):
            continue
        if entry.arg in keywords:
            out.append((entry, next(kw.value for kw in call.keywords
                                    if kw.arg == entry.arg)))
        elif entry.pos < n and bound[entry.pos] == entry.arg:
            out.append((entry, call.args[entry.pos]))
    return out


def _contains(outer: ast.AST, inner: ast.AST) -> bool:
    return any(a is outer for a in ancestors(inner)) or outer is inner


def _stores_in(scope: ast.AST) -> List[Tuple[int, Path]]:
    """(line, path) of every rebind: assignment targets, aug-assigns,
    for-targets, with-as names — the events that end an updated
    binding's lifetime."""
    out: List[Tuple[int, Path]] = []

    def targets(node):
        if isinstance(node, (ast.Tuple, ast.List)):
            for el in node.elts:
                yield from targets(el)
        elif isinstance(node, ast.Starred):
            yield from targets(node.value)
        else:
            yield node

    for node in ast.walk(scope):
        tgts: Sequence[ast.AST] = ()
        if isinstance(node, ast.Assign):
            tgts = [t for tgt in node.targets for t in targets(tgt)]
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            tgts = list(targets(node.target))
        elif isinstance(node, (ast.For, ast.comprehension)):
            tgts = list(targets(node.target))
        elif isinstance(node, ast.withitem) and node.optional_vars:
            tgts = list(targets(node.optional_vars))
        for t in tgts:
            path = _expr_path(t)
            if path is not None:
                out.append((getattr(t, "lineno", 0), path))
    return out


def _loads_of(scope: ast.AST, path: Path, exclude_within: ast.AST) -> List[int]:
    """Lines where ``path`` (or a sub-path of it) is read, outside the
    updating call itself.  Deduped per line."""
    lines = set()
    for node in ast.walk(scope):
        if not isinstance(node, (ast.Name, ast.Attribute)):
            continue
        if not isinstance(getattr(node, "ctx", None), ast.Load):
            continue
        p = _expr_path(node)
        if p is None or p[:len(path)] != path:
            continue
        if _contains(exclude_within, node):
            continue
        lines.add(node.lineno)
    return sorted(lines)


def _check_use_after(sf: SourceFile, call: ast.Call, entry: InPlace,
                     expr: ast.AST, findings: List[Finding]) -> None:
    path = _expr_path(expr)
    if path is None:
        return  # not a binding: nothing old survives to read
    if entry.field:
        path = path + (entry.field,)
    scope = enclosing_function(call) or sf.tree
    rebind_lines = sorted(line for line, spath in _stores_in(scope)
                          if spath == path[:len(spath)])
    first_rebind = min((ln for ln in rebind_lines if ln >= call.lineno), default=None)
    loop = next((a for a in ancestors(call) if isinstance(a, (ast.For, ast.While))), None)
    for line in _loads_of(scope, path, call):
        after_linear = (line > call.lineno
                        and (first_rebind is None or line < first_rebind))
        in_loop = (loop is not None
                   and loop.lineno <= line <= (loop.end_lineno or line)
                   and not any(loop.lineno <= ln <= (loop.end_lineno or 0)
                               for ln in rebind_lines))
        if after_linear or in_loop:
            findings.append(Finding(
                sf.relpath, line, "D101",
                f"`{'.'.join(path)}` is read after `{entry.func.split('.')[-1]}` "
                f"(line {call.lineno}) updated it in place — the old binding now "
                "holds the new data; use the returned state, or take "
                ".clone() before the call"))


def _check_table(sf: SourceFile, findings: List[Finding]) -> None:
    for entry in IN_PLACE:
        if entry.module != sf.module:
            continue
        fn = sf.defs.get(entry.func)
        if fn is None:
            findings.append(Finding(
                sf.relpath, 1, "D102",
                f"in-place table entry `{entry.func}` names no def of this "
                "module — the table has drifted from the code"))
            continue
        params = positional_params(fn)
        if "." in entry.func and params and params[0] in ("self", "cls"):
            params = params[1:]
        if entry.pos >= len(params) or params[entry.pos] != entry.arg:
            have = params[entry.pos] if entry.pos < len(params) else "nothing"
            findings.append(sf.finding(
                fn, "D102",
                f"in-place table entry `{entry.func}` updates `{entry.arg}` at "
                f"position {entry.pos}, but the signature has {have} there "
                f"({', '.join(params) or 'no parameters'}) — the table has "
                "drifted out of alignment with the signature"))


def run(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    _check_table(sf, findings)
    by_name: Dict[str, List[InPlace]] = {}
    for entry in IN_PLACE:
        by_name.setdefault(entry.func.split(".")[-1], []).append(entry)
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call):
            for entry, expr in _updated_arg(node, by_name):
                _check_use_after(sf, node, entry, expr, findings)
    return findings
