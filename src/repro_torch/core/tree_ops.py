"""Sum-tree op backends — port of ``repro.core.tree_ops``: one protocol,
two implementations.

  * ``torch`` — the plain tensor ops of ``core/sumtree.py`` and the
    kernels' plain versions (the counterpart of the reference's ``xla``
    backend), on any device;
  * ``cuda``  — the hand-written kernels (``kernels/ops.py``, the
    counterpart of ``pallas``) for the irregular accesses: descent,
    gather (every storage leaf in one launch), fused sample+gather and
    the eager update.  Like the
    reference's Pallas backend it keeps the plain ``write_leaves`` and
    ``flush`` (a small scatter and a dense K-aligned reshape-sum).

The replay buffer defaults to ``cuda`` on a CUDA device and ``torch`` on
the CPU.  Fused vs split sampling defaults to split.

Tree ops update the tree **in place** (and return it).  Every backend
counts its calls per op in ``counts``, so a test can assert how many
propagation passes one loop iteration runs; ``counts["gather"]`` counts
storage leaves gathered (5 a CartPole learner call), whatever the number
of launches.
"""

from __future__ import annotations

import collections
from typing import Dict, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core import sumtree
from repro_torch.core.sumtree import SumTreeSpec
# the kernels' plain versions; importing them builds nothing
from repro_torch.kernels.gather import gather_items_plain
from repro_torch.kernels.sample_gather import sample_gather_plain

Storage = Dict[str, torch.Tensor]


@runtime_checkable
class TreeOps(Protocol):
    """Backend protocol for batched sum-tree + storage ops."""

    name: str
    counts: collections.Counter

    def update(self, spec: SumTreeSpec, tree: torch.Tensor, idx: torch.Tensor,
               values: torch.Tensor, unique: bool = False) -> torch.Tensor:
        """Eager batched priority SET (last writer wins): leaf write and
        upward propagation in one op."""
        ...

    def write_leaves(self, spec: SumTreeSpec, tree: torch.Tensor,
                     idx: torch.Tensor, values: torch.Tensor,
                     unique: bool = False) -> torch.Tensor:
        """Lazy batched priority SET: leaf level only."""
        ...

    def flush(self, spec: SumTreeSpec, tree: torch.Tensor) -> torch.Tensor:
        """One merged upward pass: rebuild the interior from the leaves."""
        ...

    def sample(self, spec: SumTreeSpec, tree: torch.Tensor, u: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched inverse-CDF descent → (leaf_idx, leaf_priority)."""
        ...

    def gather_items(self, storage: Storage, idx: torch.Tensor) -> Storage:
        """out[k][i] = storage[k][idx[i]] for every storage leaf."""
        ...

    def sample_gather(self, spec: SumTreeSpec, tree: torch.Tensor,
                      u: torch.Tensor, storage: Storage
                      ) -> Tuple[torch.Tensor, torch.Tensor, Storage]:
        """Fused descent + storage fetch → (idx, priority, items)."""
        ...


class TorchTreeOps:
    """Plain-tensor reference backend."""

    name = "torch"

    def __init__(self):
        self.counts: collections.Counter = collections.Counter()

    def update(self, spec, tree, idx, values, unique=False):
        self.counts["update"] += 1
        return sumtree.update(spec, tree, idx, values, unique=unique)

    def write_leaves(self, spec, tree, idx, values, unique=False):
        self.counts["write_leaves"] += 1
        return sumtree.write_leaves(spec, tree, idx, values, unique=unique)

    def flush(self, spec, tree):
        self.counts["flush"] += 1
        return sumtree.rebuild(spec, tree)

    def sample(self, spec, tree, u):
        self.counts["sample"] += 1
        return sumtree.sample(spec, tree, u)

    def gather_items(self, storage, idx):
        self.counts["gather"] += len(storage)      # leaves gathered
        return gather_items_plain(storage, idx)

    def sample_gather(self, spec, tree, u, storage):
        self.counts["sample_gather"] += 1
        return sample_gather_plain(spec, tree, u, storage)


class CudaTreeOps(TorchTreeOps):
    """Kernel backend: the CUDA kernels for the irregular ops, the plain
    ``write_leaves``/``flush`` (inherited).  On CPU tensors the kernel
    wrappers run their plain versions."""

    name = "cuda"

    def __init__(self):
        super().__init__()
        from repro_torch.kernels import ops as kernel_ops  # lazy, as in the reference
        self._kops = kernel_ops

    def update(self, spec, tree, idx, values, unique=False):
        self.counts["update"] += 1
        return self._kops.sumtree_update(spec, tree, idx, values, unique=unique)

    def sample(self, spec, tree, u):
        self.counts["sample"] += 1
        return self._kops.sumtree_sample(spec, tree, u)

    def gather_items(self, storage, idx):
        self.counts["gather"] += len(storage)      # leaves gathered, one launch
        return self._kops.gather_items(storage, idx)

    def sample_gather(self, spec, tree, u, storage):
        self.counts["sample_gather"] += 1
        return self._kops.sumtree_sample_gather(spec, tree, u, storage)


_BACKENDS = {"torch": TorchTreeOps, "cuda": CudaTreeOps}


def get_tree_ops(backend: str) -> TreeOps:
    try:
        return _BACKENDS[backend]()
    except KeyError:
        raise ValueError(
            f"unknown tree-ops backend {backend!r}; expected one of "
            f"{sorted(_BACKENDS)}") from None
