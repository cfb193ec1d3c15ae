"""The port's lint held against a run (``chip_smoke.py`` phase 28).

``repro_torch.analysis`` finds host syncs and in-place updates by
reading the code; this module watches them happen:

  * ``SyncRecorder`` turns on ``torch.cuda.set_sync_debug_mode("warn")``
    and records the Python stack of every synchronizing CUDA call;
    ``LintIndex.site`` maps a stack to its innermost frame under
    ``src/repro_torch`` and ``LintIndex.classify`` to what the lint says
    of that line: an R401/R404 finding (flagged or waived), or a miss —
    inside a registered program's scope (the rules did not fire) or
    outside it (the scope did not reach the line);
  * ``CallRecorder`` records the port's defs a run enters, and
    ``registry_reached`` the registry entries (``analysis/retrace.py``)
    whose first port function was among them;
  * ``inplace_cases`` calls each function of the lint's in-place table
    (``analysis/donation.py``) on small inputs and reports whether the
    tensors it returns share their storage with the argument it updates.

It runs on the CPU too (the tests hold the in-place table there); the
sync recorder needs a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import tempfile
import traceback
import warnings
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.analysis import donation, retrace
from repro_torch.analysis.cli import all_findings
from repro_torch.analysis.common import PACKAGE_DIR, package_files

_HERE = os.path.abspath(__file__)


class SyncRecorder:
    """Every synchronizing CUDA call made inside the ``with`` block, as
    the Python stack that made it (``traceback.extract_stack``)."""

    def __init__(self):
        self.stacks: List[traceback.StackSummary] = []

    def __enter__(self) -> "SyncRecorder":
        # the mode first: setting it may warn of itself, which is no sync
        torch.cuda.set_sync_debug_mode("warn")
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def record(message, category, filename, lineno, file=None, line=None):
            if "synchronizing" in str(message):
                self.stacks.append(traceback.extract_stack())
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = record
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.set_sync_debug_mode(0)
        self._catch.__exit__(*exc)


class CallRecorder:
    """The defs entered inside the ``with`` block on this thread, as code
    objects (``sys.setprofile``); ``entered`` names the port's."""

    def __init__(self):
        self.codes: Set[object] = set()

    def __enter__(self) -> "CallRecorder":
        codes, self._prev = self.codes, sys.getprofile()

        def hook(frame, event, arg):
            if event == "call":
                codes.add(frame.f_code)

        sys.setprofile(hook)
        return self

    def __exit__(self, *exc) -> None:
        sys.setprofile(self._prev)

    def entered(self, index: "LintIndex") -> Set[str]:
        """``module::qualname`` of each port def entered (``<locals>.``
        dropped, as the registry writes it)."""
        out = set()
        for code in self.codes:
            module = index.module_of(code.co_filename)
            if module is not None:
                out.add(f"{module}::{code.co_qualname.replace('<locals>.', '')}")
        return out


def registry_reached(entered: Iterable[str]) -> Dict[str, List[str]]:
    """Each registry entry (by its reference function) whose first port
    function, the one that does its work, a run entered → the entry's
    port functions it entered."""
    entered = set(entered)
    return {prog.ref: [p for p in prog.port if p in entered]
            for prog in retrace.REGISTRY if prog.port[0] in entered}


@dataclasses.dataclass(frozen=True)
class Verdict:
    kind: str        # "finding" | "missed"
    rule: str = ""   # the finding's rule
    waived: bool = False
    scoped: bool = False    # the line lies in a def of a registered program's scope


class LintIndex:
    """What the lint says of each line of the port: the spans of the
    R401/R404 findings (suppressed ones included) and of the defs in a
    registered program's scope.  ``overrides`` maps a copy of a port
    module (a file elsewhere) to the module it stands for."""

    def __init__(self, package_dir: str = PACKAGE_DIR,
                 overrides: Optional[Dict[str, str]] = None):
        self.package_dir = os.path.abspath(package_dir)
        self.overrides = {os.path.abspath(k): v for k, v in (overrides or {}).items()}
        self._cache: Dict[str, Tuple[list, list]] = {}

    def site(self, stack: traceback.StackSummary) -> Optional[Tuple[str, int, str]]:
        """(file, line, function) of the innermost frame of ``stack`` in
        the package or in an override, this module's own left out; None
        if the sync came from no such frame."""
        root = self.package_dir + os.sep
        for frame in reversed(stack):
            path = os.path.abspath(frame.filename)
            if path != _HERE and (path.startswith(root) or path in self.overrides):
                return path, frame.lineno, frame.name
        return None

    def module_of(self, path: str) -> Optional[str]:
        path = os.path.abspath(path)
        if path in self.overrides:
            return self.overrides[path]
        rel = os.path.relpath(path, self.package_dir)
        return None if rel.startswith("..") else rel.replace(os.sep, "/")

    def _spans(self, path: str) -> Tuple[list, list]:
        path = os.path.abspath(path)
        if path not in self._cache:
            module = self.module_of(path)
            findings, sf = all_findings(path, f"src/repro_torch/{module}")
            waived = {f for f in findings if sf.is_suppressed(f)}
            syncs = [(f.rule, a, b, f in waived) for f, a, b in retrace.sync_sites(sf)]
            defs = [(s.fn.lineno, s.fn.end_lineno) for s in retrace.scoped(sf)]
            self._cache[path] = (syncs, defs)
        return self._cache[path]

    def classify(self, path: str, line: int) -> Verdict:
        """A sync at ``line``: an R401/R404 finding there, or a miss —
        every port line that synchronizes is one the lint must flag."""
        syncs, defs = self._spans(path)
        scoped = any(a <= line <= b for a, b in defs)
        for rule, a, b, waived in syncs:
            if a <= line <= b:
                return Verdict("finding", rule, waived, scoped)
        return Verdict("missed", scoped=scoped)


def witness(index: LintIndex, fn: Callable[[], object], calls: int) -> dict:
    """``calls`` calls of ``fn`` under the sync recorder → {"calls",
    "syncs", "per_call", "sites": [{"file", "line", "function", "kind",
    "rule", "waived", "scoped", "count"}], "missed", "reached"}: a sync
    with no port frame is of kind "outside" (the caller's own), and
    "reached" is ``registry_reached`` of the run.  ``fn``'s results are
    kept alive until the recorder is off, so no deallocation falls
    inside."""
    torch.cuda.synchronize()
    keep = []
    with SyncRecorder() as rec, CallRecorder() as calls_made:
        for _ in range(calls):
            keep.append(fn())
    torch.cuda.synchronize()
    del keep
    sites: Dict[Tuple[str, int], dict] = {}
    for stack in rec.stacks:
        where = index.site(stack)
        if where is None:
            frames = [f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                      for f in stack[-8:]]
            key = ("<outside the package>", hash(tuple(frames)))
            sites.setdefault(key, {"file": key[0], "line": 0, "function": " < ".join(
                reversed(frames)), "kind": "outside", "rule": "", "waived": False,
                "scoped": False, "count": 0})["count"] += 1
            continue
        path, line, func = where
        key = (path, line)
        if key not in sites:
            v = index.classify(path, line)
            module = index.module_of(path) or path
            sites[key] = {"file": module, "line": line, "function": func, "kind": v.kind,
                          "rule": v.rule, "waived": v.waived, "scoped": v.scoped,
                          "count": 0}
        sites[key]["count"] += 1
    out = list(sites.values())
    return {"calls": calls, "syncs": len(rec.stacks), "per_call": len(rec.stacks) / calls,
            "sites": out, "missed": sum(s["count"] for s in out if s["kind"] == "missed"),
            "reached": registry_reached(calls_made.entered(index))}


# -- the in-place table on small inputs --------------------------------------------


def _same_storage(a: List[torch.Tensor], b: List[torch.Tensor]) -> bool:
    return len(a) == len(b) and all(
        x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr() for x, y in zip(a, b))


def _train_tensors(st) -> List[torch.Tensor]:
    return (list(st.params.parameters()) + list(st.target.parameters())
            + list(st.opt.m) + list(st.opt.v))


def _replay_tensors(rs) -> List[torch.Tensor]:
    return [rs.tree] + [rs.storage[k] for k in sorted(rs.storage)]


@contextlib.contextmanager
def world_one(backend: str = "gloo") -> Iterator[None]:
    """A process group of this one process (file rendezvous in a temp
    dir), destroyed on exit."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/rdzv", rank=0,
                                world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def inplace_cases(device) -> Dict[donation.InPlace, Callable[[], bool]]:
    """For each entry of ``donation.IN_PLACE``, a call on small inputs on
    ``device`` → whether the state it returns holds the argument's own
    tensors.  ``ShardedExecutor.run_chunk`` needs a process group
    (``world_one``)."""
    from repro_torch.agents import token_dqn
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.configs import get_config
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.envs.classic import make_vec
    from repro_torch.models import backbone
    from repro_torch.quickstart import transition_example
    from repro_torch.runtime.executors import AsyncExecutor, FusedExecutor, ShardedExecutor
    from repro_torch.runtime.loop import LoopConfig
    from repro_torch.serve.buckets import BucketSpec
    from repro_torch.serve.engine import DecodeEngine

    device = torch.device(device)
    env_fn = lambda n: make_vec("cartpole", n)  # noqa: E731
    spec, _, _ = env_fn(1)
    agent = make_dqn(spec, DQNConfig(hidden=(32, 32)))
    cfg = LoopConfig(batch_size=16, warmup=16, epsilon=0.2)
    example = transition_example(spec)

    def replay_state():
        replay = PrioritizedReplay(ReplayConfig(capacity=256, fanout=8), example,
                                   device=device)
        rs = replay.init()
        items = {k: torch.zeros((8,) + tuple(v.shape), dtype=v.dtype, device=device)
                 for k, v in example.items()}
        return replay, replay.append(rs, items, lazy=True), items

    def insert_begin():
        replay, rs, _ = replay_state()
        before = _replay_tensors(rs)
        out, _ = replay.insert_begin(rs, 4, lazy=True)
        return _same_storage(before, _replay_tensors(out))

    def insert_commit():
        replay, rs, items = replay_state()
        rs, slots = replay.insert_begin(rs, 8, lazy=True)
        before = _replay_tensors(rs)
        out = replay.insert_commit(rs, slots, items, lazy=True)
        return _same_storage(before, _replay_tensors(out))

    def append():
        replay, rs, items = replay_state()
        before = _replay_tensors(rs)
        out = replay.append(rs, items, lazy=False)
        return _same_storage(before, _replay_tensors(out))

    def flush():
        replay, rs, _ = replay_state()
        before, pending = _replay_tensors(rs), rs.pending
        out = replay.flush(rs)
        return pending > 0 and _same_storage(before, _replay_tensors(out))

    def update_priorities():
        replay, rs, _ = replay_state()
        rs = replay.flush(rs)
        before = _replay_tensors(rs)
        idx = torch.arange(4, device=device)
        out = replay.update_priorities(rs, idx, torch.ones(4, device=device), lazy=False)
        return _same_storage(before, _replay_tensors(out))

    def executor(kind):
        replay = PrioritizedReplay(ReplayConfig(capacity=256, fanout=8), example,
                                   device=device)
        if kind == "async":
            return AsyncExecutor(agent, replay, env_fn, cfg, n_envs=4, publish_interval=2,
                                 scan_chunk=4, device=device)
        return FusedExecutor(agent, replay, env_fn, cfg, n_envs=4, scan_chunk=4, device=device)

    def loop_step():
        ex = executor("fused")
        st = ex.init(0)
        before = _replay_tensors(st.replay)
        out, _ = ex.step(st)
        return _same_storage(before, _replay_tensors(out.replay))

    def run_chunk(kind):
        def case():
            ex = executor(kind)
            st = ex.init(0)
            before = _replay_tensors(st.replay)
            out, _ = ex.run_chunk(st, 6)
            return _same_storage(before, _replay_tensors(out.replay))
        return case

    def sharded_run_chunk():
        from repro_torch.core.distributed import (ShardedPrioritizedReplay,
                                                  ShardedReplayConfig)
        from repro_torch.launch.mesh import data_mesh

        replay = ShardedPrioritizedReplay(
            ShardedReplayConfig(capacity_per_shard=256, fanout=8), example, device=device)
        ex = ShardedExecutor(agent, replay, env_fn, cfg, n_envs=4, mesh=data_mesh(1),
                             scan_chunk=4, device=device)
        st = ex.init(0)
        before = _replay_tensors(st.replay)
        out, _ = ex.run_chunk(st, 6)
        return _same_storage(before, _replay_tensors(out.replay))

    s_cfg = get_config("granite_8b", smoke=True)
    params = backbone.init_params(s_cfg, torch.Generator(device=device).manual_seed(1))

    def engine():
        eng = DecodeEngine(s_cfg, slots=2, max_len=16, buckets=BucketSpec((8,)), device=device)
        return eng, eng.init_state()

    def cache_tensors(state):
        return [state.cache["k"], state.cache["v"], state.cache["pos"]]

    def decode_step():
        # K and V are written in place; the step rebinds pos in the same dict
        eng, st = engine()
        cache, before = st.cache, [st.cache["k"], st.cache["v"]]
        _, out = eng.step(params, st)
        return out.cache is cache and _same_storage(before, [out.cache["k"], out.cache["v"]])

    def decode_insert():
        eng, st = engine()
        tok, slot_cache = eng.prime(params, np.arange(5, dtype=np.int32))
        before = cache_tensors(st) + [st.tokens, st.active]
        out = eng.insert(st, 0, slot_cache, tok)
        return _same_storage(before, cache_tensors(out) + [out.tokens, out.active])

    def decode_release():
        eng, st = engine()
        before = cache_tensors(st) + [st.tokens, st.active]
        out = eng.release(st, 1)
        return _same_storage(before, cache_tensors(out) + [out.tokens, out.active])

    def train_step():
        t_cfg = dataclasses.replace(get_config("internlm2_1_8b", smoke=True), dtype="float32")
        tcfg = token_dqn.TokenDQNConfig()
        st = token_dqn.init_train_state(t_cfg, tcfg, torch.Generator(device=device).manual_seed(2))
        g = torch.Generator(device=device).manual_seed(3)
        b, s = 2, 16
        batch = {"tokens": torch.randint(0, t_cfg.vocab_size, (b, s), generator=g, device=device),
                 "actions": torch.randint(0, t_cfg.vocab_size, (b, s), generator=g,
                                          device=device),
                 "rewards": torch.rand((b, s), generator=g, device=device),
                 "dones": torch.zeros((b, s), device=device),
                 "is_weights": torch.ones((b,), device=device)}
        before = _train_tensors(st)
        out, _, _ = token_dqn.train_step(t_cfg, token_dqn.NO_SHARDING, tcfg, st, batch)
        return _same_storage(before, _train_tensors(out))

    # the table's own functions (``InPlace.func``), each with its inputs
    builders = {
        "PrioritizedReplay.insert_begin": insert_begin,
        "PrioritizedReplay.insert_commit": insert_commit,
        "PrioritizedReplay.append": append,
        "PrioritizedReplay.flush": flush,
        "PrioritizedReplay.update_priorities": update_priorities,
        "make_step.step": loop_step,
        "Executor.run_chunk": run_chunk("fused"),
        "AsyncExecutor.run_chunk": run_chunk("async"),
        "ShardedExecutor.run_chunk": sharded_run_chunk,
        "DecodeEngine.step": decode_step,
        "DecodeEngine.insert": decode_insert,
        "DecodeEngine.release": decode_release,
        "train_step": train_step,
    }
    missing = [f"{e.module}::{e.func}" for e in donation.IN_PLACE if e.func not in builders]
    if missing:
        raise KeyError(f"in-place table entries with no case here: {missing}")
    return {e: builders[e.func] for e in donation.IN_PLACE}


def waivers_by_item(package_dir: str = PACKAGE_DIR) -> Dict[str, Dict[str, int]]:
    """rule → {ROADMAP item named in the reason → count} over the port's
    suppression comments."""
    import re

    out: Dict[str, Dict[str, int]] = {}
    rule_re = re.compile(r"([A-Z]\d{3})\(([^()]*)\)")
    for sf in package_files(package_dir).values():
        for line in sf.text.splitlines():
            if "repro-lint: disable=" not in line:
                continue
            for rule, reason in rule_re.findall(line.split("repro-lint: disable=", 1)[1]):
                m = re.search(r"held work ([A-Z])\b|item (\d+)", reason)
                item = (m.group(1) or m.group(2)) if m else "none"
                out.setdefault(rule, {}).setdefault(item, 0)
                out[rule][item] += 1
    return out
