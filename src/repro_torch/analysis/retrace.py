"""Pass 4 — host syncs in the port's step programs (rules R401/R404), the
port's counterpart of ``repro.analysis.retrace``.

The reference traces its step programs (``jax.jit``, ``lax.scan``,
``shard_map``, …; ``_collect_traced`` finds 38 of them), and a Python
branch on a traced value fails at trace time.  The port runs the same
programs eagerly, where such a branch does not fail: it waits for the
device (``bool(tensor)`` copies the value to the host), and a step that
waits cannot be captured as a CUDA graph (``runtime/loop.py``: no
``.item()``, no ``bool(tensor)``).  ``REGISTRY`` lists, for each of the
reference's 38 traced functions, the port functions that do its work on
each call and their host-side inputs (each has a counterpart).

Scope: each registered function's body, and every def that a call in a
scoped body resolves to statically (a def lexically visible from the
call, a method of the enclosing class through ``self``, or a def of a
port module the file imports).  Calls through objects (``replay.sample``)
do not resolve; the registry lists such methods itself.  ``REGISTRY`` is
the only way to register a program (``sync_sites`` takes other roots,
for the lint's own fixtures).

A value is tensor-valued when it is a parameter (not ``self``, not a
registered host-side input, not annotated with a host type such as
``int``, ``bool`` or a ``*Config``, not defaulted to a constant), or a
local assigned from an expression that reads one, or the result of a
``torch.*`` call.  Reads of a host-side input's attribute
(``state.env_steps``) are host reads.

  * **R401 host-sync-branch** — an ``if``/``while``/ternary/``assert``
    test, an ``and``/``or`` operand or a ``not`` operand that reads a
    tensor-valued name: Python converts it with ``bool()``, which waits
    for the device.  Exempt, as in the reference: ``x is None``, shape
    and metadata probes (``.shape``/``.ndim``/``.dtype``/``.size``/
    ``.device``, …), ``len``/``isinstance``/``hasattr``, a def that
    returns only metadata of its arguments (``kernels/ops.py::_on_cpu``),
    the iterable of a loop, and the other branch of an ``isinstance(x,
    torch.Tensor)`` test.
  * **R404 host-sync-call** — on a tensor-valued expression:
    ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
    ``bool()``/``int()``/``float()``, ``torch.nonzero``/``masked_select``/
    ``unique`` (their size depends on the data); ``torch.cuda.synchronize``;
    and a host-to-device copy that waits: ``.to(device)``/``.cuda()`` of a
    host tensor (``torch.from_numpy``, ``torch.tensor`` or
    ``torch.as_tensor`` without a device), ``torch.tensor``/
    ``torch.as_tensor`` with a device, and a Python number written into a
    tensor by index (``active[slot] = True``, ``tokens[slot] = n`` with
    ``n`` a host-side input, a parameter annotated ``int``/``float``/
    ``bool`` or a local annotated so).

The reference's R402 (mutable closure) and R403 (unhashable static) have
no meaning for a program that runs eagerly: each call re-reads its
closure, and nothing is keyed by a static argument.  They come back with
the CUDA-graph capture of ROADMAP.md's held work A, where a captured
step freezes what it read at capture time.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.common import (Finding, FunctionNode, SourceFile,
                                         ancestors, package_files, register_rules,
                                         resolve_call)

register_rules({
    "R401": "host-sync-branch",
    "R404": "host-sync-call",
})


@dataclasses.dataclass(frozen=True)
class Program:
    """One of the reference's traced functions and its port counterpart."""

    ref: str                    # "runtime/executors.py::FusedExecutor._build_chunk.chunk"
    # "module::qualname" under src/repro_torch: the first does the work on
    # each call, the others are defs it reaches through objects
    port: Tuple[str, ...]
    host: Tuple[str, ...] = ()  # host-side inputs: parameter or attribute names


# the iteration clock and the replay's host ledger (runtime/loop.py,
# core/replay.py): host ints that depend only on the iteration count
LOOP_HOST = ("env_steps", "learn_steps", "params_age", "head", "count", "pending")
REPLAY_OPS = tuple(f"core/replay.py::PrioritizedReplay.{m}" for m in (
    "insert_begin", "insert_commit", "append", "flush", "sample", "update_priorities",
    "get_priority", "_tree_write"))
SHARDED_REPLAY_OPS = tuple(f"core/distributed.py::ShardedPrioritizedReplay.{m}" for m in (
    "insert_begin", "insert_commit", "append", "flush", "sample", "update_priorities",
    "global_stats", "max_across"))
TREE_OPS = tuple(f"core/tree_ops.py::TorchTreeOps.{m}" for m in (
    "update", "write_leaves", "flush", "sample", "gather_items", "sample_gather")) + tuple(
    f"core/tree_ops.py::CudaTreeOps.{m}" for m in (
        "update", "sample", "gather_items", "sample_gather"))
AGENT_LEARN = ("agents/dqn.py::make_dqn.learn", "agents/dqn.py::make_dqn.grads_fn",
               "agents/dqn.py::make_dqn.apply_fn", "agents/dqn.py::make_dqn.act")
LOOP_STEP = ("runtime/loop.py::make_step.step", "runtime/loop.py::make_actor_step.actor_step",
             "runtime/loop.py::make_learner_step.learner_step", "runtime/loop.py::publish",
             "runtime/loop.py::epsilon_schedule") + REPLAY_OPS + TREE_OPS + AGENT_LEARN
# the EF buffer, a list or dict of tensors whose truth value says whether
# the compressed reduce runs, and the publish age, a host int
SHARDED_HOST = LOOP_HOST + ("ef", "age")
SHARDED_STEP = ("runtime/learner.py::make_sharded_learn.sharded_learn",
                "runtime/learner.py::make_grad_reducer.reduce_grads") + SHARDED_REPLAY_OPS

REGISTRY: Tuple[Program, ...] = (
    # agents: the reference's value_and_grad of each loss
    Program("agents/ddpg.py::make_ddpg.learn.loss_fn", ("agents/ddpg.py::make_ddpg.learn",
                                                        "agents/ddpg.py::make_ddpg.act")),
    Program("agents/dqn.py::make_dqn.grads_fn.loss_fn", AGENT_LEARN),
    Program("agents/sac.py::make_sac.learn.loss_fn", ("agents/sac.py::make_sac.learn",)),
    Program("agents/td3.py::make_td3.learn.loss_fn", ("agents/td3.py::make_td3.learn",)),
    Program("agents/token_dqn.py::train_step.<lambda>", ("agents/token_dqn.py::_td_loss",)),
    Program("agents/token_dqn.py::train_step.micro",
            ("agents/token_dqn.py::train_step",
             "kernels/flash_attention.py::FlashAttention.forward",
             "kernels/flash_attention.py::FlashAttention.backward")),
    # the replay kernels' jitted entry points
    Program("kernels/ops.py::sumtree_sample", ("kernels/ops.py::sumtree_sample",
                                               "core/tree_ops.py::CudaTreeOps.sample")),
    Program("kernels/ops.py::sumtree_update", ("kernels/ops.py::sumtree_update",
                                               "core/tree_ops.py::CudaTreeOps.update")),
    Program("kernels/ops.py::sumtree_sample_gather",
            ("kernels/ops.py::sumtree_sample_gather",
             "core/tree_ops.py::CudaTreeOps.sample_gather")),
    Program("kernels/ops.py::prioritized_gather",
            ("kernels/ops.py::prioritized_gather", "kernels/ops.py::gather_items",
             "core/tree_ops.py::CudaTreeOps.gather_items")),
    # the gang's processes (launch/multiprocess.py)
    Program("launch/multiprocess.py::_service_actor_worker.chunk",
            ("launch/multiprocess.py::_service_actor_worker.rollout",), host=("env_steps0",)),
    Program("launch/multiprocess.py::_service_actor_worker.chunk.body",
            ("runtime/loop.py::make_actor_program.program",
             "runtime/loop.py::make_actor_step.actor_step"), host=LOOP_HOST),
    Program("launch/multiprocess.py::_equiv_worker.program",
            ("launch/multiprocess.py::_equiv_worker.b_chain",
             "launch/multiprocess.py::_equiv_worker.o_chain",
             "runtime/learner.py::make_grad_reducer.reduce_grads"), host=SHARDED_HOST),
    Program("launch/multiprocess.py::_eval_policy.<lambda>",
            ("runtime/loop.py::make_actor_program.program",), host=LOOP_HOST),
    Program("launch/multiprocess.py::_eval_policy.body",
            ("runtime/loop.py::make_actor_program.program",), host=LOOP_HOST),
    # the token trainer (launch/train.py)
    Program("launch/train.py::main.collect", ("launch/train.py::collect",
                                              "envs/token_mdp.py::make.step")),
    Program("launch/train.py::main.collect.one", ("launch/train.py::collect",
                                                  "envs/token_mdp.py::make.step")),
    Program("launch/train.py::_make_param_averager.pmean",
            ("launch/train.py::make_param_averager.sync",)),
    # the models' scanned and checkpointed bodies
    Program("models/backbone.py::_scan_units.unit", ("models/backbone.py::_run_units",
                                                     "models/backbone.py::_unit")),
    Program("models/backbone.py::_whisper_forward.unit", ("models/backbone.py::_encode",
                                                          "models/backbone.py::_unit")),
    Program("models/layers.py::_attn_chunked_q.chunk_fn", ("models/layers.py::_attn_chunked_q",),
            host=("is_global", "causal")),
    Program("models/layers.py::_attn_flash.local", ("models/layers.py::_attn_flash",),
            host=("is_global", "causal")),
    Program("models/mamba.py::mamba_scan.step", ("models/mamba.py::mamba_scan",)),
    Program("models/xlstm.py::mlstm_forward.<lambda>", ("models/xlstm.py::mlstm_forward",)),
    Program("models/xlstm.py::mlstm_prefill_state.<lambda>",
            ("models/xlstm.py::mlstm_prefill_state",)),
    Program("models/xlstm.py::mlstm_forward_chunked.body",
            ("models/xlstm.py::mlstm_forward_chunked",)),
    Program("models/xlstm.py::slstm_forward.<lambda>", ("models/xlstm.py::slstm_forward",)),
    Program("models/xlstm.py::slstm_prefill_state.<lambda>",
            ("models/xlstm.py::slstm_prefill_state",)),
    # the executors' chunks (runtime/executors.py)
    Program("runtime/executors.py::FusedExecutor._build_chunk.chunk",
            ("runtime/executors.py::Executor.run_chunk",
             "runtime/executors.py::AsyncExecutor.run_chunk"), host=LOOP_HOST),
    Program("runtime/executors.py::FusedExecutor._build_chunk.chunk.body", LOOP_STEP,
            host=LOOP_HOST),
    Program("runtime/executors.py::ShardedExecutor.__init__.init_local",
            ("runtime/executors.py::ShardedExecutor.init",), host=LOOP_HOST),
    Program("runtime/executors.py::ShardedExecutor._build_chunk.chunk_local.body",
            ("runtime/loop.py::make_step.step",) + SHARDED_STEP, host=SHARDED_HOST),
    Program("runtime/executors.py::ShardedExecutor._build_chunk.chunk_local",
            ("runtime/executors.py::ShardedExecutor.run_chunk",
             "runtime/executors.py::ShardedExecutor._reduce_metrics"), host=LOOP_HOST),
    # the actor server's engine (serve/engine.py)
    Program("serve/engine.py::DecodeEngine.__init__.prime",
            ("serve/engine.py::DecodeEngine.prime",)),
    Program("serve/engine.py::DecodeEngine.__init__.insert",
            ("serve/engine.py::DecodeEngine.insert",)),
    Program("serve/engine.py::DecodeEngine.__init__.release",
            ("serve/engine.py::DecodeEngine.release",)),
    # the replay service (service/)
    Program("service/executor.py::ServiceExecutor._window.window",
            ("service/executor.py::ServiceExecutor._window",
             "service/executor.py::ServiceExecutor._stratified_learn"), host=LOOP_HOST),
    Program("service/server.py::ReplayService._make_sample_fn.fn",
            ("service/server.py::ReplayService.sample",
             "service/server.py::stratified_sample"), host=LOOP_HOST),
    # not among the 38: the reference jits the vmapped serve_step, which
    # _collect_traced does not resolve (serve/engine.py:121)
    Program("serve/engine.py::DecodeEngine.__init__._step",
            ("serve/engine.py::DecodeEngine.step", "agents/token_dqn.py::serve_step")),
)

# parameter annotations that hold no tensor
_HOST_TYPES = {
    "int", "float", "bool", "str", "bytes", "None", "NoneType", "device", "dtype",
    "Generator", "ndarray", "Path", "Namespace", "DeviceLike", "RatioSchedule", "Agent",
    "PrioritizedReplay", "ShardedPrioritizedReplay", "Mesh", "DeviceMesh", "Callable",
}
_HOST_TYPE_SUFFIXES = ("Config", "Spec")
_SCALAR_TYPES = {"int", "float", "bool"}
_TYPING_WRAPPERS = {"Optional", "Union", "Tuple", "List", "Dict", "Sequence", "Iterable",
                    "Mapping", "Set", "FrozenSet", "Type", "typing", "Literal"}
# attribute reads and methods that return metadata, not data
_META_ATTRS = {
    "shape", "ndim", "dtype", "size", "device", "is_cuda", "requires_grad", "layout",
    "placements", "device_mesh", "is_meta", "numel", "dim", "stride", "is_contiguous",
    "element_size", "data_ptr", "untyped_storage", "is_floating_point", "get_device",
    "nelement", "names", "type",
}
_META_CALLS = {"len", "isinstance", "hasattr", "getattr", "type", "callable", "id",
               "torch.is_tensor", "torch.is_floating_point", "torch.is_complex",
               "torch.is_grad_enabled", "torch.finfo", "torch.iinfo"}
# torch calls that return host values
_HOST_TORCH = {"is_tensor", "is_floating_point", "is_complex", "is_grad_enabled",
               "is_inference_mode_enabled", "device", "Size", "get_default_dtype", "finfo",
               "iinfo", "Generator", "no_grad", "enable_grad", "inference_mode",
               "set_grad_enabled", "manual_seed"}
_HOST_TORCH_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.distributed.",
                        "torch.utils.", "torch.library.", "torch.ops.")
_CONTAINERS = {"List", "Sequence", "Tuple", "Dict", "Iterable", "Mapping", "list",
               "tuple", "dict", "Set", "set", "Leaves", "Storage"}
_CONTAINER_NODES = (ast.List, ast.Tuple, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                    ast.SetComp)
_CONTAINER_CALLS = {"list", "tuple", "dict", "set", "sorted", "zip", "enumerate", "range"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_BUILTINS = {"bool", "int", "float"}
_DATA_SIZED = {"nonzero", "masked_select", "unique", "unique_consecutive"}
_HOST_TENSOR_MAKERS = {"torch.from_numpy", "torch.tensor", "torch.as_tensor"}


def _annotation_leaves(ann: ast.AST) -> List[str]:
    """The type names of an annotation, typing wrappers unwrapped and a
    ``Callable[...]`` taken whole: ``Optional[torch.Tensor]`` →
    ["Tensor"]."""
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return []
    if isinstance(ann, ast.Constant) and ann.value is None:
        return ["None"]
    if isinstance(ann, ast.Subscript):
        head = _annotation_leaves(ann.value)
        if head == ["Callable"]:
            return head
        elts = ann.slice.elts if isinstance(ann.slice, ast.Tuple) else [ann.slice]
        return [n for el in elts for n in _annotation_leaves(el)]
    if isinstance(ann, (ast.Tuple, ast.List)):
        return [n for el in ann.elts for n in _annotation_leaves(el)]
    if isinstance(ann, ast.BinOp):        # X | None
        return _annotation_leaves(ann.left) + _annotation_leaves(ann.right)
    name = ann.attr if isinstance(ann, ast.Attribute) else getattr(ann, "id", None)
    if name is None or name == "Ellipsis":
        return []
    return [] if name in _TYPING_WRAPPERS else [name]


def _annotation_is_host(ann: ast.AST, modules: Set[str]) -> bool:
    """No tensor in the annotation: host types, and modules (branching on
    a module, or on its attributes, never reads the device)."""
    leaves = _annotation_leaves(ann)
    return bool(leaves) and all(
        n in _HOST_TYPES or n in modules or n.endswith(_HOST_TYPE_SUFFIXES) for n in leaves)


def _annotation_is_scalar(ann: ast.AST) -> bool:
    """``int``, ``float``, ``bool`` (``Optional`` of one too)."""
    leaves = _annotation_leaves(ann)
    return bool(set(leaves) & _SCALAR_TYPES) and set(leaves) <= _SCALAR_TYPES | {"None"}


def _annotation_is_container(ann: ast.AST) -> bool:
    node = ann.value if isinstance(ann, ast.Subscript) else ann
    name = node.attr if isinstance(node, ast.Attribute) else getattr(node, "id", "")
    return name in _CONTAINERS


def _returns_host(ann: ast.AST) -> bool:
    """``Callable[[...], bool]``: a callable parameter whose result is a
    host value (``Optional`` of one too)."""
    if isinstance(ann, ast.Subscript) and getattr(ann.value, "id", None) == "Optional":
        ann = ann.slice
    if not (isinstance(ann, ast.Subscript) and isinstance(ann.slice, ast.Tuple)
            and len(ann.slice.elts) == 2):
        return False
    ret = ann.slice.elts[1]
    return getattr(ret, "id", None) in ("bool", "int", "float", "str")


def _params(fn: ast.AST) -> List[Tuple[ast.arg, Optional[ast.AST]]]:
    a = fn.args
    pos = list(a.posonlyargs) + list(a.args)
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    out = list(zip(pos, defaults)) + list(zip(a.kwonlyargs, a.kw_defaults))
    out += [(p, None) for p in (a.vararg, a.kwarg) if p is not None]
    return out


def _param_kind(p: ast.arg, default: Optional[ast.AST], host: Set[str],
                modules: Set[str]) -> str:
    """"host", "tensor" (annotated so), or "unknown" (unannotated)."""
    if p.arg in ("self", "cls") or p.arg in host:
        return "host"
    if isinstance(default, ast.Constant) and default.value is not None:
        return "host"
    if p.annotation is None:
        return "unknown"
    return "host" if _annotation_is_host(p.annotation, modules) else "tensor"


def _targets(node: ast.AST) -> Iterable[ast.Name]:
    """The names a binding target binds (not the ``self`` of ``self.x``)."""
    if isinstance(node, ast.Name):
        yield node
    elif isinstance(node, (ast.Tuple, ast.List)):
        for el in node.elts:
            yield from _targets(el)
    elif isinstance(node, ast.Starred):
        yield from _targets(node.value)


_MODULES: Dict[int, Set[str]] = {}


def _module_classes(files: Dict[str, SourceFile]) -> Set[str]:
    """Names of the port's ``nn.Module`` subclasses, to a fixed point."""
    if id(files) in _MODULES:
        return _MODULES[id(files)]
    out = {"Module", "ModuleDict", "ModuleList", "Sequential", "Linear", "Embedding"}
    classes = [(n.name, [b.attr if isinstance(b, ast.Attribute) else getattr(b, "id", "")
                         for b in n.bases])
               for sf in files.values() for n in ast.walk(sf.tree)
               if isinstance(n, ast.ClassDef)]
    changed = True
    while changed:
        changed = False
        for name, bases in classes:
            if name not in out and any(b in out for b in bases):
                out.add(name)
                changed = True
    _MODULES[id(files)] = out
    return out


class _Scope:
    """Which names of one scoped def (its nested defs included) hold
    tensors, which hold containers (whose truthiness is a host read), and
    the exemption rules of a read.  ``params``: the def's parameters known
    to hold tensors; a nested def's unannotated parameters are taken to."""

    def __init__(self, sf: SourceFile, fn: ast.AST, host: Set[str],
                 files: Dict[str, SourceFile], params: Set[str], modules: Set[str]):
        self.sf, self.fn, self.host, self.files = sf, fn, host, files
        self.modules = modules
        self.tensors: Set[str] = set(params)
        self.containers: Set[str] = set()
        self.host_tensors: Set[str] = set()
        self.host_callables: Set[str] = set()
        # names annotated with a Python number type: host scalars
        self.host_scalars: Set[str] = {
            n.target.id for n in ast.walk(fn) if isinstance(n, ast.AnnAssign)
            and isinstance(n.target, ast.Name) and _annotation_is_scalar(n.annotation)}
        for f in [fn] + [n for n in ast.walk(fn) if isinstance(n, FunctionNode)]:
            for p, default in _params(f):
                kind = _param_kind(p, default, host, modules)
                if p.annotation is not None and _annotation_is_scalar(p.annotation):
                    self.host_scalars.add(p.arg)
                if p.annotation is not None and _annotation_is_container(p.annotation):
                    self.containers.add(p.arg)
                if p.annotation is not None and _returns_host(p.annotation):
                    self.host_callables.add(p.arg)
                if f is not fn and kind != "host":
                    self.tensors.add(p.arg)
        binds = []
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.NamedExpr)) \
                    and node.value is not None:
                tgts = node.targets if isinstance(node, ast.Assign) else [node.target]
                for tgt in tgts:
                    for t, v in self._pairs(tgt, node.value):
                        binds.append(([t], v))
                        if v is not None and _is_container(v):
                            self.containers.update(n.id for n in _targets(t))
            elif isinstance(node, (ast.For, ast.comprehension)):
                binds.append(([node.target], node.iter))
            elif isinstance(node, ast.withitem) and node.optional_vars is not None:
                binds.append(([node.optional_vars], node.context_expr))
        changed = True
        while changed:
            changed = False
            for tgts, value in binds:
                is_t, is_h = self.tensor_valued(value), self.host_tensor(value)
                for tgt in tgts:
                    for t in _targets(tgt):
                        if t.id in host:
                            continue    # a host-side input stays one when rebound
                        if is_t and t.id not in self.tensors:
                            self.tensors.add(t.id)
                            changed = True
                        if is_h and t.id not in self.host_tensors:
                            self.host_tensors.add(t.id)
                            changed = True

    def _pairs(self, tgt: ast.AST, value: ast.AST) -> List[Tuple[ast.AST, ast.AST]]:
        """(target, value) element by element where a tuple is unpacked
        from a tuple display, or from a call whose every return is a
        tuple display of that length (its containers stay containers)."""
        if not isinstance(tgt, (ast.Tuple, ast.List)) or any(
                isinstance(el, ast.Starred) for el in tgt.elts):
            return [(tgt, value)]
        n = len(tgt.elts)
        if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == n:
            return [p for t, v in zip(tgt.elts, value.elts) for p in self._pairs(t, v)]
        if isinstance(value, ast.Call):
            target = resolve_call(self.sf, value, self.files)
            sf = self.files.get(target[0]) if target is not None else None
            fn = sf.defs.get(target[1]) if sf is not None else None
            rets = [r.value for r in ast.walk(fn) if isinstance(r, ast.Return)
                    and not _inside_nested(r, fn)] if fn is not None else []
            if rets and all(isinstance(r, ast.Tuple) and len(r.elts) == n for r in rets):
                for i, t in enumerate(tgt.elts):
                    if all(_is_container(r.elts[i]) for r in rets):
                        self.containers.update(x.id for x in _targets(t))
        return [(tgt, value)]

    # -- what an expression is ------------------------------------------------

    def tensor_valued(self, expr: ast.AST) -> bool:
        if self.reads(expr) is not None:
            return True
        for node in ast.walk(expr):
            if isinstance(node, ast.Call) and self._torch_tensor_call(node) \
                    and not self._exempt(node, expr):
                return True
        return False

    def host_tensor(self, expr: ast.AST) -> bool:
        """A CPU tensor made from host data: ``torch.from_numpy``,
        ``torch.tensor``/``as_tensor`` without a device, or a name bound to
        one (through ``.long()``-style casts too)."""
        node = expr
        while isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr not in ("to", "cuda") \
                and self.sf.qualname(node.func) not in _HOST_TENSOR_MAKERS:
            node = node.func.value
        if isinstance(node, ast.Name):
            return node.id in self.host_tensors
        if isinstance(node, ast.Call):
            qn = self.sf.qualname(node.func)
            return qn in _HOST_TENSOR_MAKERS and not any(
                kw.arg == "device" for kw in node.keywords)
        return False

    def _torch_tensor_call(self, call: ast.Call) -> bool:
        qn = self.sf.qualname(call.func)
        if qn is None or not qn.startswith("torch.") or qn.startswith(_HOST_TORCH_PREFIXES):
            return False
        return qn.split(".")[-1] not in _HOST_TORCH

    def reads(self, expr: ast.AST) -> Optional[ast.Name]:
        """The first read in ``expr`` of a tensor-valued name that is not
        exempt."""
        for node in ast.walk(expr):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                    and node.id in self.tensors and not self._exempt(node, expr):
                return node
        return None

    def _exempt(self, node: ast.AST, stop: ast.AST) -> bool:
        prev: ast.AST = node
        for anc in ancestors(node):
            if isinstance(anc, (ast.If, ast.IfExp)) and prev is not anc.test \
                    and self._narrowed(node, anc, prev):
                return True
            prev = anc
        parent = getattr(node, "_rl_parent", None)
        if getattr(node, "id", None) in self.containers and (
                node is stop or isinstance(parent, ast.BoolOp)
                or (isinstance(parent, ast.UnaryOp) and isinstance(parent.op, ast.Not))):
            return True     # a list's or a dict's truth value: its length
        if node is stop:
            return False
        prev: ast.AST = node
        for anc in ancestors(node):
            if isinstance(anc, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in anc.ops):
                return True
            if isinstance(anc, ast.Attribute) and (anc.attr in _META_ATTRS
                                                   or anc.attr in self.host):
                return True
            if isinstance(anc, ast.comprehension) and prev is anc.iter:
                return True
            if isinstance(anc, ast.Call) and prev is not anc.func:
                if self._host_call(anc):
                    return True
            if isinstance(anc, ast.Call) and prev is anc.func \
                    and isinstance(anc.func, ast.Attribute) and anc.func.attr in _SYNC_METHODS:
                return True
            if anc is stop:
                return False
            prev = anc
        return False

    def _host_call(self, call: ast.Call) -> bool:
        """A call whose result is a host value whatever its arguments:
        metadata probes, the sync conversions (flagged by R404 instead),
        and port defs that return only metadata of their arguments."""
        qn = self.sf.qualname(call.func)
        if qn in _META_CALLS or qn in _SYNC_BUILTINS or qn in self.host_callables:
            return True
        if qn is not None and qn.split(".")[-1] in ("is_dtensor",):
            return True
        target = resolve_call(self.sf, call, self.files)
        return target is not None and _host_predicate(target, self.files)

    @staticmethod
    def _narrowed(node: ast.AST, branch: ast.AST, prev: ast.AST) -> bool:
        """``node`` (a Name) sits in the branch of ``branch`` where an
        ``isinstance(name, ...Tensor)`` test is false."""
        test, negated = branch.test, False
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test, negated = test.operand, True
        if not (isinstance(test, ast.Call) and isinstance(test.func, ast.Name)
                and test.func.id == "isinstance" and len(test.args) == 2
                and isinstance(test.args[0], ast.Name)
                and test.args[0].id == getattr(node, "id", None)
                and "Tensor" in ast.dump(test.args[1])):
            return False
        in_else = (prev is branch.orelse if isinstance(branch, ast.IfExp)
                   else any(prev is s for s in branch.orelse))
        return in_else != negated

    # -- the rules ---------------------------------------------------------------

    def check(self, emit) -> None:
        tests: List[ast.AST] = []
        for node in ast.walk(self.fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                tests.append(node.test)
        in_test = {id(n) for t in tests for n in ast.walk(t)}
        for node in ast.walk(self.fn):
            if id(node) in in_test:
                continue
            if isinstance(node, ast.BoolOp):
                tests.extend(node.values[:-1])
                in_test.update(id(n) for v in node.values[:-1] for n in ast.walk(v))
            elif isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
                tests.append(node.operand)
                in_test.update(id(n) for n in ast.walk(node.operand))
        for test in tests:
            ref = self.reads(test)
            if ref is not None:
                emit(test, "R401",
                     f"Python branch on tensor-valued `{ref.id}` in a step program — "
                     "bool() copies it to the host and waits for the device; keep "
                     "the decision on the device (torch.where) or on a host-side input")
        for node in ast.walk(self.fn):
            what = None
            if isinstance(node, ast.Call):
                what = self._sync_call(node)
            elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store):
                what = self._scalar_store(node)
            if what is not None:
                emit(node, "R404",
                     f"{what} in a step program waits for the device — keep the "
                     "value on the device, or move the read out of the step")

    def _scalar_store(self, target: ast.Subscript) -> Optional[str]:
        """``x[i] = 1``, ``x[i] = n``: a Python number written into a
        tensor by index is made a host tensor and copied to the device,
        which waits."""
        stmt = getattr(target, "_rl_parent", None)
        if not isinstance(stmt, (ast.Assign, ast.AugAssign)):
            return None
        if not self._host_number(stmt.value):
            return None
        key = target.slice
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            return None     # a dict's entry
        if not self.tensor_valued(target.value) or self._container_root(target.value):
            return None
        return "a Python number written into a tensor by index (a host-to-device copy)"

    def _host_number(self, value: ast.AST) -> bool:
        """A Python number: a literal, a host-side input (or its attribute,
        ``state.env_steps``), or a name annotated ``int``/``float``/``bool``."""
        if isinstance(value, ast.UnaryOp):
            value = value.operand
        if isinstance(value, ast.Constant):
            return isinstance(value.value, (bool, int, float))
        if isinstance(value, ast.Name):
            return value.id in self.host or value.id in self.host_scalars
        return isinstance(value, ast.Attribute) and value.attr in self.host

    def _container_root(self, expr: ast.AST) -> bool:
        while isinstance(expr, (ast.Subscript, ast.Attribute)):
            expr = expr.value
        return isinstance(expr, ast.Name) and expr.id in self.containers

    def _sync_call(self, call: ast.Call) -> Optional[str]:
        func = call.func
        qn = self.sf.qualname(func)
        if qn is not None and qn.endswith("cuda.synchronize"):
            return "torch.cuda.synchronize()"
        if qn in _SYNC_BUILTINS and call.args and self.tensor_valued(call.args[0]):
            return f"{qn}() of a tensor"
        if qn is not None and qn.startswith("torch.") and qn.split(".")[-1] in _DATA_SIZED:
            return f"{qn}() (its size depends on the data)"
        if qn in ("torch.tensor", "torch.as_tensor") and any(
                kw.arg == "device" and not _is_cpu(kw.value) for kw in call.keywords):
            return f"{qn}(..., device=...) (a host-to-device copy)"
        if not isinstance(func, ast.Attribute):
            return None
        recv = func.value
        if func.attr in ("to", "cuda") and self.host_tensor(recv) and not (
                call.args and _is_cpu(call.args[0])):
            return f".{func.attr}() of a host tensor (a host-to-device copy)"
        if not self.tensor_valued(recv):
            return None
        if func.attr in _SYNC_METHODS:
            return f".{func.attr}()"
        if func.attr in _DATA_SIZED:
            return f".{func.attr}() (its size depends on the data)"
        if func.attr == "to" and (any(_is_cpu(a) for a in call.args[:1]) or any(
                kw.arg == "device" and _is_cpu(kw.value) for kw in call.keywords)):
            return '.to("cpu")'
        return None


def _is_container(value: ast.AST) -> bool:
    return isinstance(value, _CONTAINER_NODES) or (
        isinstance(value, ast.Call) and getattr(value.func, "id", None) in _CONTAINER_CALLS)


def _is_cpu(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and node.args:
        return isinstance(node.args[0], ast.Constant) and node.args[0].value == "cpu"
    return False


# -- host predicates: defs that return only metadata of their arguments ---------

_PREDICATES: Dict[Tuple[str, str, str], bool] = {}


def _host_predicate(target: Tuple[str, str], files: Dict[str, SourceFile]) -> bool:
    sf = files.get(target[0])
    key = target + (sf.path if sf is not None else "",)
    if key not in _PREDICATES:
        _PREDICATES[key] = False          # a recursive def is not one
        fn = sf.defs.get(target[1]) if sf is not None else None
        ok = False
        if fn is not None:
            modules = _module_classes(files)
            params = {p.arg for p, d in _params(fn)
                      if _param_kind(p, d, set(), modules) != "host"}
            scope = _Scope(sf, fn, set(), files, params, modules)
            returns = [n.value for n in ast.walk(fn) if isinstance(n, ast.Return)
                       and n.value is not None and not _inside_nested(n, fn)]
            ok = bool(returns) and not any(scope.tensor_valued(r) for r in returns)
        _PREDICATES[key] = ok
    return _PREDICATES[key]


def _inside_nested(node: ast.AST, fn: ast.AST) -> bool:
    for anc in ancestors(node):
        if anc is fn:
            return False
        if isinstance(anc, FunctionNode):
            return True
    return False


# -- the scope: registered programs and the defs they call ----------------------

Key = Tuple[str, str]       # (module under src/repro_torch, def qualname)

# parameter names that carry configuration, not data, in every registered
# program: read as host-side inputs
CONVENTIONAL_HOST = ("cfg", "tcfg", "shd", "spec", "mesh", "device", "dtype")


def split_port(entry: str) -> Key:
    module, _, qualname = entry.partition("::")
    return module, qualname


def _closure(roots: Iterable[Tuple[Key, Tuple[str, ...]]],
             files: Dict[str, SourceFile]) -> Dict[Key, Set[str]]:
    """Every def reachable from ``roots`` through static calls → the union
    of the host-side inputs of the programs that reach it."""
    scope: Dict[Key, Set[str]] = {}
    work = [(key, set(host)) for key, host in roots]
    while work:
        key, host = work.pop()
        have = scope.get(key)
        if have is not None and host <= have:
            continue
        scope[key] = (have or set()) | host
        sf = files.get(key[0])
        fn = sf.defs.get(key[1]) if sf is not None else None
        if fn is None:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                target = resolve_call(sf, node, files)
                if target is not None and target[0] in files:
                    work.append((target, scope[key]))
    return scope


class _Analysis:
    """The scope of a set of programs over ``files``, with each scoped
    def's tensor-valued parameters: a registered def's unannotated
    parameters hold tensors unless they are host-side inputs; a def
    reached through calls gets them from its call sites."""

    def __init__(self, roots: List[Tuple[Key, Tuple[str, ...]]],
                 files: Dict[str, SourceFile]):
        self.files = files
        self.modules = _module_classes(files)
        self.scope = _closure(roots, files)
        root_keys = {key for key, _ in roots}
        self.defs: Dict[Key, Tuple[SourceFile, ast.AST]] = {}
        self.params: Dict[Key, Set[str]] = {}
        self._scopes: Dict[Key, Tuple[int, _Scope]] = {}
        for key, host in self.scope.items():
            sf = files.get(key[0])
            fn = sf.defs.get(key[1]) if sf is not None else None
            if fn is None:
                continue
            self.defs[key] = (sf, fn)
            self.params[key] = {
                p.arg for p, d in _params(fn)
                if _param_kind(p, d, host, self.modules) == "tensor"
                or (key in root_keys and p.arg not in CONVENTIONAL_HOST
                    and _param_kind(p, d, host, self.modules) == "unknown")}
        changed = True
        while changed:
            changed = False
            for key in list(self.defs):
                for target, name in self._tensor_args(key):
                    if name not in self.params[target]:
                        self.params[target].add(name)
                        changed = True

    def scope_of(self, key: Key) -> "_Scope":
        """The def's ``_Scope`` at its current parameters (which only grow)."""
        have = self._scopes.get(key)
        if have is None or have[0] != len(self.params[key]):
            sf, fn = self.defs[key]
            have = (len(self.params[key]), _Scope(sf, fn, self.scope[key], self.files,
                                                  self.params[key], self.modules))
            self._scopes[key] = have
        return have[1]

    def _tensor_args(self, key: Key) -> Iterable[Tuple[Key, str]]:
        """(callee, parameter) for each unannotated parameter of a scoped
        callee that a call in ``key`` passes a tensor-valued argument."""
        sc = self.scope_of(key)
        for call in ast.walk(sc.fn):
            if not isinstance(call, ast.Call):
                continue
            target = resolve_call(sc.sf, call, self.files)
            if target not in self.defs:
                continue
            tfn = self.defs[target][1]
            kinds = {p.arg: _param_kind(p, d, self.scope[target], self.modules)
                     for p, d in _params(tfn)}
            pos = [p.arg for p in list(tfn.args.posonlyargs) + list(tfn.args.args)]
            if pos and pos[0] in ("self", "cls") and isinstance(call.func, ast.Attribute):
                pos = pos[1:]
            for i, arg in enumerate(call.args):
                name = pos[i] if i < len(pos) else (
                    tfn.args.vararg.arg if tfn.args.vararg is not None else None)
                if isinstance(arg, ast.Starred):
                    arg = arg.value
                if name is not None and kinds.get(name) == "unknown" \
                        and sc.tensor_valued(arg):
                    yield target, name
            for kw in call.keywords:
                if kw.arg is not None and kinds.get(kw.arg) == "unknown" \
                        and sc.tensor_valued(kw.value):
                    yield target, kw.arg


_REGISTRY_ANALYSES: Dict[int, _Analysis] = {}


def _registry_roots() -> List[Tuple[Key, Tuple[str, ...]]]:
    return [(split_port(p), prog.host) for prog in REGISTRY for p in prog.port]


def registry_analysis(files: Optional[Dict[str, SourceFile]] = None) -> _Analysis:
    """The registry's scope over the port's own modules (built once a
    process, and once for each copy of a module that is scanned)."""
    files = package_files() if files is None else files
    if id(files) not in _REGISTRY_ANALYSES:
        _REGISTRY_ANALYSES[id(files)] = _Analysis(_registry_roots(), files)
    return _REGISTRY_ANALYSES[id(files)]


def _files_for(sf: SourceFile) -> Dict[str, SourceFile]:
    files = package_files()
    if sf.module and sf.module in files and files[sf.module].path != sf.path:
        key = (sf.module, sf.path, sf.text)
        if key not in _OVERRIDES:
            _OVERRIDES[key] = {**files, sf.module: sf}   # a copy of a port module
        return _OVERRIDES[key]
    return files


_OVERRIDES: Dict[Tuple[str, str, str], Dict[str, SourceFile]] = {}


def scoped(sf: SourceFile, roots: Optional[Dict[str, Tuple[str, ...]]] = None
           ) -> List["_Scope"]:
    """A ``_Scope`` for every def of ``sf`` in scope: the registry's, or,
    with ``roots`` ({def qualname: host-side inputs}), those defs of ``sf``
    and the defs of ``sf`` they call."""
    if roots is not None:
        module = sf.module or ""
        analysis = _Analysis([((module, q), host) for q, host in roots.items()],
                             {module: sf})
        return [analysis.scope_of(key) for key in sorted(analysis.defs)]
    if not sf.module:
        return []
    analysis = registry_analysis(_files_for(sf))
    return [analysis.scope_of(key) for key in sorted(analysis.defs) if key[0] == sf.module]


def sync_sites(sf: SourceFile, roots: Optional[Dict[str, Tuple[str, ...]]] = None
               ) -> List[Tuple[Finding, int, int]]:
    """Every R401/R404 finding of ``sf`` before suppression, with the line
    span of the expression it is about (an ``if`` test, a call); the
    registry's programs, or ``roots`` as ``scoped`` takes them."""
    out: List[Tuple[Finding, int, int]] = []
    seen: Set[Tuple[int, int, str]] = set()

    def emit(node: ast.AST, rule: str, message: str) -> None:
        span = (node.lineno, getattr(node, "end_lineno", None) or node.lineno)
        if span + (rule,) in seen:
            return
        seen.add(span + (rule,))
        out.append((sf.finding(node, rule, message),) + span)

    for scope in scoped(sf, roots):
        scope.check(emit)
    return out


def run(sf: SourceFile) -> List[Finding]:
    return [f for f, _, _ in sync_sites(sf)]
