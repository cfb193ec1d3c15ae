"""Pass 2 — collective uniformity over ``torch.distributed`` (rules
C201/C202), the port's counterpart of ``repro.analysis.collectives``.

The reference traces one program a process under ``shard_map``; the port
runs every rank's whole program eagerly (``launch/mesh.py``: one process
a shard).  Every rank must still issue the *same sequence* of
collectives, or the gang deadlocks at the first mismatched rendezvous.
So the scope of C201 is every function of the scanned files, not only
the mapped ones.

  * **C201 collective-divergent-control** — a collective lexically under
    an ``if``/``while`` test, a ternary's test or a ``for`` iterable that
    reads a source that differs between ranks: ``dist.get_rank``,
    ``DeviceMesh.get_local_rank``/``get_coordinate``, the port mesh's
    ``shard_id``/``coords``/``axis_index``, and the reference's
    ``time.*``, ``random.*``, ``numpy.random.*``, ``os.environ``/
    ``getenv``/``getpid``/``urandom``, ``socket.gethostname``, ``uuid.*``.
    A local assigned from such a source, and a def of the same module
    that returns one (``checkpoint/elastic.py::_rank``), read as the
    source itself.
  * **C202 collective-unknown-axis** — an axis-name literal outside the
    mesh axis set {``pod``, ``data``, ``model``} at ``mesh.group("…")``,
    ``mesh["…"]``, ``get_group("…")``, ``mesh_dim_names=`` and the
    ``axes`` argument of the port's collectives.

Collectives are ``torch.distributed``'s (``all_reduce``, ``all_gather*``,
``reduce_scatter*``, ``broadcast*``, ``all_to_all*``, ``barrier``; the
functional forms too), the port's own (``optim/collectives.py``:
``all_reduce_axes``, ``fused_tree_reduce``, ``broadcast_``) and the
host-staged all-gather of ``launch/mesh.py``.  Point-to-point
``send``/``recv`` are asymmetric by design and are not collectives here.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.common import (Finding, SourceFile, ancestors,
                                         register_rules)

register_rules({
    "C201": "collective-divergent-control",
    "C202": "collective-unknown-axis",
})

KNOWN_MESH_AXES = {"pod", "data", "model"}

# last path segment of a torch.distributed collective
DIST_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "all_gather_tensor", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "broadcast_object_list", "all_to_all", "all_to_all_single",
    "barrier", "all_reduce_coalesced", "all_gather_coalesced",
}
# the port's own: optim/collectives.py and launch/mesh.py's host all-gather
PORT_COLLECTIVES = {"all_reduce_axes", "fused_tree_reduce", "broadcast_",
                    "_all_gather_via_host"}
# the port collectives whose second positional argument is the axes
_AXES_SECOND = {"all_reduce_axes", "fused_tree_reduce"}

# dotted prefixes whose reads differ between ranks of one gang
_NONUNIFORM_PREFIXES = (
    "torch.distributed.get_rank",
    "time.", "random.", "numpy.random.",
    "os.environ", "os.getenv", "os.urandom", "os.getpid",
    "socket.gethostname", "uuid.",
)
# attribute reads and calls on a mesh that differ between its ranks
_NONUNIFORM_ATTRS = {"get_rank", "get_local_rank", "get_coordinate",
                     "shard_id", "coords", "axis_index"}


def is_collective(sf: SourceFile, call: ast.Call) -> bool:
    qn = sf.qualname(call.func)
    if qn is None:
        return False
    tail = qn.split(".")[-1]
    if tail in PORT_COLLECTIVES:
        return True
    return tail in DIST_COLLECTIVES and qn.startswith("torch.distributed.")


def _is_mesh(node: ast.AST) -> bool:
    """A receiver named like a mesh: ``mesh``, ``self.mesh``,
    ``device_mesh``."""
    name = node.attr if isinstance(node, ast.Attribute) else \
        node.id if isinstance(node, ast.Name) else ""
    return "mesh" in name.lower()


class _Sources:
    """The nonuniform sources of one module: the fixed prefixes, the
    module's defs that return one, and each function's locals assigned
    from one."""

    def __init__(self, sf: SourceFile):
        self.sf = sf
        self.defs: Set[str] = set()
        self._locals: Dict[int, Set[str]] = {}
        top = [n for n in getattr(sf.tree, "body", [])
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        changed = True
        while changed:
            changed = False
            for fn in top:
                if fn.name in self.defs:
                    continue
                if any(isinstance(n, ast.Return) and n.value is not None
                       and self.read(n.value, set()) for n in ast.walk(fn)):
                    self.defs.add(fn.name)
                    changed = True

    def read(self, expr: ast.AST, local: Set[str]) -> Optional[str]:
        """The first nonuniform source ``expr`` reads, or None."""
        for node in ast.walk(expr):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                    and node.id in local:
                return node.id
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id in self.defs:
                return node.func.id + "()"
            if isinstance(node, ast.Attribute) and node.attr in _NONUNIFORM_ATTRS:
                return self.sf.qualname(node) or node.attr
            qn = self.sf.qualname(node)
            if qn is None:
                continue
            for prefix in _NONUNIFORM_PREFIXES:
                if qn == prefix.rstrip(".") or (qn + ".").startswith(prefix):
                    return qn
        return None

    def locals_of(self, fn: Optional[ast.AST]) -> Set[str]:
        """Names a function assigns from a nonuniform source (to a fixed
        point, so ``r = get_rank(); first = r == 0`` marks both)."""
        if fn is None:
            return set()
        key = id(fn)
        if key not in self._locals:
            local: Set[str] = set()
            assigns = [n for n in ast.walk(fn) if isinstance(n, ast.Assign)]
            changed = True
            while changed:
                changed = False
                for node in assigns:
                    if self.read(node.value, local) is None:
                        continue
                    for tgt in node.targets:
                        for t in ast.walk(tgt):
                            if isinstance(t, ast.Name) and t.id not in local:
                                local.add(t.id)
                                changed = True
            self._locals[key] = local
        return self._locals[key]


def _check_divergence(sf: SourceFile, src: _Sources, call: ast.Call,
                      findings: List[Finding]) -> None:
    fns = [a for a in ancestors(call)
           if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))]
    local: Set[str] = set()
    for fn in fns:
        local |= src.locals_of(fn)
    for anc in ancestors(call):
        cond: Optional[ast.AST] = None
        if isinstance(anc, (ast.If, ast.While, ast.IfExp)):
            cond = anc.test
        elif isinstance(anc, ast.For):
            cond = anc.iter
        if cond is None or any(a is cond for a in ancestors(call)):
            continue
        what = src.read(cond, local)
        if what is not None:
            findings.append(sf.finding(
                call, "C201",
                f"collective under control flow conditioned on `{what}` — "
                "ranks of the gang can disagree on whether this collective "
                "launches, which deadlocks the rendezvous (hoist the "
                "branch, or make every rank take it)"))
            return


def _string_literals(node: ast.AST) -> List[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [el.value for el in node.elts
                if isinstance(el, ast.Constant) and isinstance(el.value, str)]
    return []


def _axis_literals(sf: SourceFile, node: ast.AST) -> List[str]:
    """Axis-name literals at the forms C202 reads."""
    out: List[str] = []
    if isinstance(node, ast.Subscript) and _is_mesh(node.value):
        out += _string_literals(node.slice)
    if not isinstance(node, ast.Call):
        return out
    func = node.func
    if isinstance(func, ast.Attribute) and node.args and (
            (func.attr == "group" and _is_mesh(func.value))
            or func.attr == "get_group"):
        out += _string_literals(node.args[0])
    for kw in node.keywords:
        if kw.arg == "mesh_dim_names":
            out += _string_literals(kw.value)
    qn = sf.qualname(func)
    tail = qn.split(".")[-1] if qn else None
    if tail in PORT_COLLECTIVES:
        if tail in _AXES_SECOND and len(node.args) > 1:
            out += _string_literals(node.args[1])
        out += [s for kw in node.keywords if kw.arg in ("axes", "axis")
                for s in _string_literals(kw.value)]
    return out


def run(sf: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    src = _Sources(sf)
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Call) and is_collective(sf, node):
            _check_divergence(sf, src, node, findings)
        for name in _axis_literals(sf, node):
            if name not in KNOWN_MESH_AXES:
                findings.append(sf.finding(
                    node, "C202",
                    f"axis name '{name}' is not in the known mesh axis set "
                    f"{sorted(KNOWN_MESH_AXES)} — a typo'd axis only fails "
                    "on the real mesh of ranks, not in unit tests"))
    return findings
