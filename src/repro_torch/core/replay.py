"""Prioritized replay buffer with lazy-writing transactions (paper §IV-D)
— port of ``repro.core.replay``.

The same transaction as the reference: with ``lazy=True`` every mutation
(``insert_begin`` zeroes the in-flight slots, ``update_priorities``
writes fresh priorities, ``insert_commit`` restores P_max) writes only
the sum tree's leaf level and adds to the pending ledger, and ``flush``
brings the interior back in sync with one rebuild pass.  The rebuild is
a pure function of the leaves, so a lazy flush is bit-exact with
flushing after every op.  ``lazy=False`` keeps the eager per-op form.

Differences from the functional reference, both for a loop that never
waits on the device:

  * The tree and the storage are updated **in place**.  Each op still
    returns a ``ReplayState``, but it shares its tensors with the state
    passed in; ``ReplayState.clone()`` keeps an old state readable.
  * ``head``, ``count`` and the ``pending`` ledger are host ints: they
    depend only on how many items were written, never on the data.  So
    ``flush`` decides on the host whether anything is pending (no
    GPU→CPU read) and stays an exact no-op on a clean tree.

Priorities follow PER: stored ``p = (|δ| + ε)^α``; importance weights
``w = (N·Pr(i))^(-β) / max_w``; new insertions receive P_max.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import sumtree, tree_ops
from repro_torch.core.sumtree import SumTreeSpec
from repro_torch.device import DeviceLike, resolve_device

Storage = Dict[str, torch.Tensor]


@dataclasses.dataclass
class ReplayState:
    """State of one replay buffer."""

    tree: torch.Tensor           # flat K-ary sum tree (priorities^α)
    storage: Storage             # {name: (capacity, ...) tensor}
    head: int                    # next insert position (FIFO eviction)
    count: int                   # number of valid entries (≤ capacity)
    max_priority: torch.Tensor   # f32 scalar — running P_max (^α-scaled)
    pending: int = 0             # leaf writes whose propagation is deferred

    def clone(self) -> "ReplayState":
        return dataclasses.replace(
            self, tree=self.tree.clone(),
            storage={k: v.clone() for k, v in self.storage.items()},
            max_priority=self.max_priority.clone())


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    capacity: int
    fanout: int = sumtree.DEFAULT_FANOUT
    alpha: float = 0.6              # priority exponent
    eps: float = 1e-6               # priority floor
    backend: Optional[str] = None   # "cuda" | "torch"; None → "cuda" on a
                                    # CUDA device, "torch" on the CPU
    fused_sample_gather: bool = False   # descend + fetch rows in one kernel

    def tree_backend(self, device: torch.device) -> str:
        return self.backend or ("cuda" if device.type == "cuda" else "torch")


class PrioritizedReplay:
    """Single-shard prioritized replay buffer (paper §IV).

    Batched throughout: B parallel inserts / samples / updates per call.
    ``example_item`` maps each storage field to a tensor of one item's
    shape and dtype.  State lives on ``device`` (CUDA unless ``"cpu"``).

    **Transaction contract**: with ``lazy=True`` the mutating ops write
    only the leaf level and add to the pending ledger; the caller must
    ``flush`` before the next ``sample`` (the runtime loop flushes once
    per iteration).  With ``lazy=False`` every op leaves the tree fully
    consistent.
    """

    def __init__(self, config: ReplayConfig, example_item: Storage,
                 device: DeviceLike = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.spec: SumTreeSpec = sumtree.make_spec(config.capacity, config.fanout)
        self._example = {k: torch.as_tensor(v) for k, v in example_item.items()}
        self.ops: tree_ops.TreeOps = tree_ops.get_tree_ops(
            config.tree_backend(self.device))

    # -- state ------------------------------------------------------------

    def init(self) -> ReplayState:
        cap = self.config.capacity
        storage = {k: torch.zeros((cap,) + tuple(x.shape), dtype=x.dtype,
                                  device=self.device)
                   for k, x in self._example.items()}
        return ReplayState(
            tree=sumtree.init(self.spec, self.device),
            storage=storage, head=0, count=0,
            max_priority=torch.ones((), dtype=torch.float32, device=self.device),
            pending=0)

    # -- tree-op dispatch ---------------------------------------------------

    def _tree_write(self, state: ReplayState, idx, vals, *, lazy: bool,
                    unique: bool = False) -> Tuple[torch.Tensor, int]:
        """One priority SET through the backend: eager (write + propagate)
        or lazy (leaf write, ledger bump).  Returns (tree, pending)."""
        if lazy:
            tree = self.ops.write_leaves(self.spec, state.tree, idx, vals,
                                         unique=unique)
            return tree, state.pending + idx.shape[0]
        tree = self.ops.update(self.spec, state.tree, idx, vals, unique=unique)
        return tree, state.pending

    # -- the flush boundary ---------------------------------------------------

    def flush(self, state: ReplayState) -> ReplayState:
        """Apply every deferred leaf write's propagation in one rebuild
        pass and reset the ledger; an exact no-op when nothing is pending."""
        if state.pending == 0:
            return state
        tree = self.ops.flush(self.spec, state.tree)
        return dataclasses.replace(state, tree=tree, pending=0)

    # -- insertion (lazy writing, paper Alg. 3 INSERT) ----------------------

    def insert_slots(self, state: ReplayState, batch: int) -> torch.Tensor:
        """FIFO slot allocation: the next ``batch`` indices after head."""
        return (torch.arange(batch, dtype=torch.int64, device=self.device)
                + state.head) % self.config.capacity

    def insert_begin(self, state: ReplayState, batch: int, *,
                     lazy: bool = False) -> Tuple[ReplayState, torch.Tensor]:
        """Phase 1 — zero the in-flight slots' priorities.

        ``batch`` may not exceed the capacity: the FIFO slot allocation
        would wrap onto duplicate indices, and duplicate-index storage
        writes resolve in unspecified order.
        """
        if batch > self.config.capacity:
            raise ValueError(
                f"insert batch={batch} exceeds capacity="
                f"{self.config.capacity}: the FIFO slot allocation would "
                "wrap onto duplicate indices and the duplicate-index "
                "scatter writes into storage resolve in unspecified order "
                "— insert at most `capacity` items per call (or grow the "
                "buffer)")
        slots = self.insert_slots(state, batch)
        zeros = torch.zeros((batch,), dtype=torch.float32, device=self.device)
        tree, pending = self._tree_write(state, slots, zeros, lazy=lazy,
                                         unique=True)
        return dataclasses.replace(state, tree=tree, pending=pending), slots

    def insert_commit(self, state: ReplayState, slots: torch.Tensor,
                      items: Storage, *, lazy: bool = False) -> ReplayState:
        """Phase 2 — storage write, then restore priority to P_max."""
        for k, buf in state.storage.items():
            buf.index_copy_(0, slots, items[k].to(buf.dtype))
        batch = slots.shape[0]
        pmax = state.max_priority.expand(batch)
        tree, pending = self._tree_write(state, slots, pmax, lazy=lazy,
                                         unique=True)
        return dataclasses.replace(
            state, tree=tree,
            head=(state.head + batch) % self.config.capacity,
            count=min(state.count + batch, self.config.capacity),
            pending=pending)

    def insert(self, state: ReplayState, items: Storage) -> ReplayState:
        """Begin + commit in one eager call (the result is consistent)."""
        batch = next(iter(items.values())).shape[0]
        state, slots = self.insert_begin(state, batch)
        return self.insert_commit(state, slots, items)

    def append(self, state: ReplayState, items: Storage, *,
               lazy: bool = True) -> ReplayState:
        """Writer transaction: begin + commit with no learner call between
        them; with ``lazy=True`` the items become sampleable atomically at
        the next ``flush``."""
        batch = next(iter(items.values())).shape[0]
        state, slots = self.insert_begin(state, batch, lazy=lazy)
        return self.insert_commit(state, slots, items, lazy=lazy)

    # -- sampling (paper Alg. 3 SAMPLE) ---------------------------------------

    def sample(self, state: ReplayState, generator: Optional[torch.Generator],
               batch: int, beta: float = 0.4, u: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Storage, torch.Tensor]:
        """Prioritized sample of ``batch`` items → (indices, items,
        importance weights).  ``u`` overrides the uniform draws (parity
        tests feed the reference's); else they come from ``generator``.
        The caller must have flushed (``state.pending == 0``).
        """
        if u is None:
            u = torch.rand((batch,), generator=generator, device=self.device)
        if self.config.fused_sample_gather:
            idx, pri, items = self.ops.sample_gather(self.spec, state.tree, u,
                                                     state.storage)
        else:
            idx, pri = self.ops.sample(self.spec, state.tree, u)
            items = {k: self.ops.gather(buf, idx)
                     for k, buf in state.storage.items()}
        prob = pri / torch.clamp(state.tree[0], min=1e-12)
        w = (float(max(state.count, 1)) * torch.clamp(prob, min=1e-12)) ** (-beta)
        # an fp-tail draw can land on a zero-priority leaf (in-flight or
        # unfilled slot): its weight is 0, not 0**(-β) = inf
        w = torch.where(pri > 0, w, torch.zeros_like(w))
        w = w / torch.clamp(w.max(), min=1e-12)
        return idx, items, w

    # -- priority maintenance ---------------------------------------------------

    def priorities_from_td(self, td_errors: torch.Tensor) -> torch.Tensor:
        return (td_errors.abs() + self.config.eps) ** self.config.alpha

    def update_priorities(self, state: ReplayState, idx: torch.Tensor,
                          td_errors: torch.Tensor, *, lazy: bool = False
                          ) -> ReplayState:
        """Write-after-read tolerated (paper §IV-D3).  Indices whose
        current priority is zero (a dead slot hit by an fp-tail draw) are
        skipped: they stay at zero."""
        cur = self.get_priority(state, idx)
        pri = torch.where(cur > 0, self.priorities_from_td(td_errors),
                          torch.zeros_like(cur))
        tree, pending = self._tree_write(state, idx, pri, lazy=lazy)
        return dataclasses.replace(
            state, tree=tree,
            max_priority=torch.maximum(state.max_priority, pri.max()),
            pending=pending)

    def get_priority(self, state: ReplayState, idx: torch.Tensor) -> torch.Tensor:
        """Leaf read — always current (lazy writes defer only the interior)."""
        return sumtree.get(self.spec, state.tree, idx)

    def total_priority(self, state: ReplayState) -> torch.Tensor:
        return sumtree.total(self.spec, state.tree)
