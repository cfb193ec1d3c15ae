"""Pass 3 — lock discipline in the threaded service layer (rules
L301/L302/L303): a copy of ``repro.analysis.locks``, with its semantics.

The lock protocol of DESIGN.md §11, which the port's ``service/``
keeps: ReplayService shard state lives behind ``self._lock``, the params
bus behind ``self._params_cond``, and the RateLimiter debt window behind
``self._cond``.  The guarded sets
are *inferred*, not declared: any attribute a class assigns under
``with self.<lock>:`` (outside ``__init__``) is treated as
lock-protected everywhere in that class.

  * **L301 lock-unguarded-attr** — a read or write of an inferred
    guarded attribute lexically outside every ``with self.<lock>:``
    block (and outside ``__init__``, which runs before any thread can
    see the object).  Holding *any* of the class's locks satisfies the
    rule — cross-lock confusion is out of scope for a lexical pass.
    Helpers whose callers hold the lock (the RateLimiter predicate
    lambdas) are the intended audience for a def-line
    ``# repro-lint: disable=L301(reason)``.
  * **L302 lock-wait-no-while** — ``self.<cond>.wait(...)`` not inside
    a ``while`` loop: bare waits miss spurious wakeups and notify races;
    ``wait_for`` carries its own predicate loop and is exempt.
  * **L303 lock-notify-unlocked** — ``self.<cond>.notify()`` /
    ``notify_all()`` outside a ``with self.<cond>:`` block for that
    same condition (notify on an unheld Condition raises RuntimeError,
    but only on the code path that actually races).

The pass runs per ``ClassDef``; module-level locks are out of scope
(the repo has none).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.common import (Finding, SourceFile, ancestors,
                                   register_rules)

register_rules({
    "L301": "lock-unguarded-attr",
    "L302": "lock-wait-no-while",
    "L303": "lock-notify-unlocked",
})

_LOCK_TYPES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _lock_attrs(cls: ast.ClassDef, sf: SourceFile) -> Dict[str, str]:
    """attr name → lock type for every ``self.x = threading.Lock()``."""
    out: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        attr = _self_attr(node.targets[0])
        if attr is None or not isinstance(node.value, ast.Call):
            continue
        qn = sf.qualname(node.value.func)
        if qn is None:
            continue
        parts = qn.split(".")
        if parts[-1] in _LOCK_TYPES and (len(parts) == 1
                                         or parts[0] == "threading"):
            out[attr] = parts[-1]
    return out


def _held_locks(node: ast.AST, locks: Dict[str, str],
                stop_at: ast.AST) -> Set[str]:
    """Lock attrs held at ``node``: with-statements on self.<lock>
    between the node and its enclosing method."""
    held: Set[str] = set()
    for anc in ancestors(node):
        if isinstance(anc, ast.With):
            for item in anc.items:
                attr = _self_attr(item.context_expr)
                if attr in locks:
                    held.add(attr)
        if anc is stop_at:
            break
    return held


def _methods(cls: ast.ClassDef) -> List[ast.FunctionDef]:
    return [n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _check_class(sf: SourceFile, cls: ast.ClassDef,
                 findings: List[Finding]) -> None:
    locks = _lock_attrs(cls, sf)
    if not locks:
        return
    conds = {a for a, t in locks.items() if t == "Condition"}
    methods = _methods(cls)

    # infer the guarded set: attrs assigned under a lock outside __init__
    guarded: Set[str] = set()
    for meth in methods:
        if meth.name == "__init__":
            continue
        for node in ast.walk(meth):
            attr = _self_attr(node)
            if attr is None or attr in locks:
                continue
            if isinstance(getattr(node, "ctx", None), (ast.Store, ast.Del)) \
                    and _held_locks(node, locks, meth):
                guarded.add(attr)

    for meth in methods:
        init = meth.name == "__init__"
        for node in ast.walk(meth):
            # L302 / L303: condition-variable protocol
            if isinstance(node, ast.Call):
                cond_attr = None
                if isinstance(node.func, ast.Attribute):
                    cond_attr = _self_attr(node.func.value)
                if cond_attr in conds:
                    op = node.func.attr
                    if op == "wait":
                        in_while = any(isinstance(a, ast.While)
                                       for a in ancestors(node))
                        if not in_while:
                            findings.append(sf.finding(
                                node, "L302",
                                f"self.{cond_attr}.wait() outside a "
                                "predicate `while` loop — spurious "
                                "wakeups and notify races slip through a "
                                "bare wait (or use wait_for)"))
                    elif op in ("notify", "notify_all"):
                        if cond_attr not in _held_locks(node, locks, meth):
                            findings.append(sf.finding(
                                node, "L303",
                                f"self.{cond_attr}.{op}() without holding "
                                f"self.{cond_attr} — notify on an unheld "
                                "Condition raises RuntimeError on the "
                                "racing path"))
            # L301: guarded attr touched lock-free
            attr = _self_attr(node)
            if attr in guarded and not init \
                    and not _held_locks(node, locks, meth):
                verb = ("write" if isinstance(node.ctx, (ast.Store, ast.Del))
                        else "read")
                findings.append(sf.finding(
                    node, "L301",
                    f"{verb} of self.{attr} outside any lock, but the "
                    f"class assigns it under "
                    f"{'/'.join('self.' + a for a in sorted(locks))} — "
                    "either take the lock or suppress on the enclosing "
                    "def with the reason the caller holds it"))


def run(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.ClassDef):
            _check_class(sf, node, findings)
    return findings
