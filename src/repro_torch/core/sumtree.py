"""K-ary sum tree (paper §IV) on torch tensors — port of ``repro.core.sumtree``.

Same implicit, pointer-free layout as the reference: one flat f32 tensor
holding every level top-down, ``offsets[l]`` the start of level ``l``,
sibling groups of K contiguous and K-aligned, the root padded to a full
group of K, and one scratch slot at the end that absorbs masked
(duplicate) writes.

These functions are the plain reference for the tree ops (the CUDA
kernels in ``repro_torch/kernels`` are held against them).  Unlike the
functional JAX version they **update ``tree`` in place** and return it;
callers that need the old tree must ``clone`` it first.  Batch semantics
match sequential application: ``update``/``write_leaves`` resolve
duplicate indices last-writer-wins, ``add`` accumulates duplicates,
``sample`` is a pure read.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

DEFAULT_FANOUT = 128


def _ceil_to(x: int, k: int) -> int:
    return ((x + k - 1) // k) * k


@dataclasses.dataclass(frozen=True)
class SumTreeSpec:
    """Static description of a K-ary sum tree (shapes only, no tensors)."""

    capacity: int                  # number of usable leaves (N)
    fanout: int                    # K
    level_sizes: Tuple[int, ...]   # padded node count per level, top-down
    offsets: Tuple[int, ...]       # flat-array offset of each level
    total_size: int                # flat array length (incl. scratch slot)

    @property
    def height(self) -> int:
        """Number of levels below the padded-root level."""
        return len(self.level_sizes) - 1

    @property
    def leaf_level(self) -> int:
        return len(self.level_sizes) - 1

    @property
    def leaf_offset(self) -> int:
        return self.offsets[self.leaf_level]

    @property
    def num_leaves(self) -> int:
        return self.level_sizes[self.leaf_level]

    @property
    def scratch_slot(self) -> int:
        return self.total_size - 1

    def groups(self, level: int) -> int:
        return self.level_sizes[level] // self.fanout


def make_spec(capacity: int, fanout: int = DEFAULT_FANOUT) -> SumTreeSpec:
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if fanout < 2:
        raise ValueError(f"fanout must be >= 2, got {fanout}")
    sizes: List[int] = [_ceil_to(capacity, fanout)]
    while sizes[0] > fanout:        # build upward until one group of K remains
        sizes.insert(0, _ceil_to(sizes[0] // fanout, fanout))
    sizes.insert(0, fanout)         # padded root level
    offsets = [0]
    for s in sizes[:-1]:
        offsets.append(offsets[-1] + s)
    return SumTreeSpec(capacity=capacity, fanout=fanout,
                       level_sizes=tuple(sizes), offsets=tuple(offsets),
                       total_size=sum(sizes) + 1)


def init(spec: SumTreeSpec, device="cpu", dtype=torch.float32) -> torch.Tensor:
    return torch.zeros((spec.total_size,), dtype=dtype, device=device)


def total(spec: SumTreeSpec, tree: torch.Tensor) -> torch.Tensor:
    """Σ priorities — the root value."""
    return tree[0]


def get(spec: SumTreeSpec, tree: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Priority retrieval, one read per index."""
    return tree[spec.leaf_offset + idx]


def last_writer_mask(idx: torch.Tensor, num_slots: int | None = None
                     ) -> torch.Tensor:
    """mask[i] = True iff no j > i has idx[j] == idx[i].

    Sort-based: sort (idx, position) pairs and mark the last entry of
    each equal-idx run.  With ``num_slots`` (an exclusive bound on the
    index values) and ``num_slots * B < 2**31`` the two keys pack into
    one sort key ``idx * B + pos``; otherwise a stable sort of ``idx``
    carries the positions.  Both give the identical mask.
    """
    b = idx.shape[0]
    if b <= 1:
        return torch.ones((b,), dtype=torch.bool, device=idx.device)
    idx = idx.to(torch.int64)
    pos = torch.arange(b, dtype=torch.int64, device=idx.device)
    if num_slots is not None and num_slots * b < 2**31:
        packed = torch.sort(idx * b + pos).values
        sidx, spos = packed // b, packed % b
    else:
        sidx, spos = torch.sort(idx, stable=True)
    run_end = torch.ones((b,), dtype=torch.bool, device=idx.device)
    run_end[:-1] = sidx[1:] != sidx[:-1]
    mask = torch.empty((b,), dtype=torch.bool, device=idx.device)
    mask[spos] = run_end
    return mask


def _ancestor_indices(spec: SumTreeSpec, idx: torch.Tensor) -> List[torch.Tensor]:
    """Node index of ``idx``'s ancestor at every level, top-down."""
    out = [idx]
    cur = idx
    for _ in range(spec.leaf_level - 1, -1, -1):
        cur = cur // spec.fanout
        out.append(cur)
    return out[::-1]


def update(spec: SumTreeSpec, tree: torch.Tensor, idx: torch.Tensor,
           values: torch.Tensor, *, unique: bool = False) -> torch.Tensor:
    """Batched priority SET with upward delta propagation, in place.

    Duplicates resolve last-writer-wins; ``unique=True`` skips the dedup
    for caller-guaranteed distinct indices.  Per level the deltas are
    scatter-added (``index_add_``), so deltas of distinct leaves that
    share an ancestor sum there.
    """
    idx = idx.to(torch.int64)
    values = values.to(tree.dtype)
    mask = (torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
            if unique else last_writer_mask(idx, spec.num_leaves))
    old = tree[spec.leaf_offset + idx]
    delta = torch.where(mask, values - old, torch.zeros_like(values))
    leaf_target = torch.where(mask, spec.leaf_offset + idx,
                              torch.full_like(idx, spec.scratch_slot))
    tree[leaf_target] = values
    ancestors = _ancestor_indices(spec, idx)
    for level in range(spec.leaf_level - 1, -1, -1):
        tree.index_add_(0, spec.offsets[level] + ancestors[level], delta)
    tree[spec.scratch_slot:].zero_()   # on the device: a Python scalar store would sync
    return tree


def write_leaves(spec: SumTreeSpec, tree: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor, *, unique: bool = False) -> torch.Tensor:
    """Leaf-only priority SET, in place: the interior lags until the
    next ``rebuild`` (the deferred half of a lazy write)."""
    idx = idx.to(torch.int64)
    values = values.to(tree.dtype)
    if unique:
        tree[spec.leaf_offset + idx] = values
        return tree
    mask = last_writer_mask(idx, spec.num_leaves)
    leaf_target = torch.where(mask, spec.leaf_offset + idx,
                              torch.full_like(idx, spec.scratch_slot))
    tree[leaf_target] = values
    tree[spec.scratch_slot:].zero_()   # on the device: a Python scalar store would sync
    return tree


def rebuild(spec: SumTreeSpec, tree: torch.Tensor) -> torch.Tensor:
    """Recompute every interior level from the leaf level, in place.

    The interior becomes a pure function of the leaves (K-aligned
    reshape-sums), which makes lazy ≡ eager bit-exact at flush points.
    """
    k = spec.fanout
    level_vals = tree[spec.leaf_offset:spec.leaf_offset + spec.num_leaves]
    for level in range(spec.leaf_level - 1, -1, -1):
        groups = level_vals.shape[0] // k
        off, size = spec.offsets[level], spec.level_sizes[level]
        dst = tree[off:off + size]
        dst[:groups] = level_vals.reshape(groups, k).sum(dim=-1)
        dst[groups:].zero_()
        level_vals = dst
    return tree


def add(spec: SumTreeSpec, tree: torch.Tensor, idx: torch.Tensor,
        deltas: torch.Tensor) -> torch.Tensor:
    """Batched priority increment, in place (duplicates accumulate)."""
    idx = idx.to(torch.int64)
    deltas = deltas.to(tree.dtype)
    ancestors = _ancestor_indices(spec, idx)
    for level in range(spec.leaf_level, -1, -1):
        tree.index_add_(0, spec.offsets[level] + ancestors[level], deltas)
    return tree


def sample(spec: SumTreeSpec, tree: torch.Tensor, u: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched inverse-CDF descent → (leaf_idx int64, leaf_priority).

    ``u`` ∈ [0, 1): B draws.  The residual ``clip(u) · tree[0]`` walks
    down one K-wide sibling row per level: the first lane whose
    inclusive cumsum reaches the residual (lane K-1 if none does, the fp
    tail).  The leaf is clamped to ``capacity - 1`` and its priority is
    re-read after the clamp.

    When the interior exceeds its leaves (f32 drift), fp-tail no-hits can
    cascade into a padding node, which has no child row.  Every leaf
    below such a node lies past ``capacity``, so the draw clamps to
    ``capacity - 1`` whatever it reads on the way; the row read is
    clamped into the level so it stays inside the tree.
    """
    k = spec.fanout
    u = u.to(tree.dtype)
    residual = torch.clamp(u, 1e-12, 1.0 - 1e-7) * tree[0]
    group = torch.zeros(u.shape, dtype=torch.int64, device=tree.device)
    lanes = torch.arange(k, dtype=torch.int64, device=tree.device)
    for level in range(1, spec.leaf_level + 1):
        row = torch.clamp(group, max=spec.groups(level) - 1)
        base = spec.offsets[level] + row * k
        rows = tree[base[:, None] + lanes]                 # (B, K) sibling rows
        csum = torch.cumsum(rows, dim=-1)
        hit = csum >= residual[:, None]
        cutoff = torch.argmax(hit.to(torch.int8), dim=-1)  # first hit
        cutoff = torch.where(hit.any(dim=-1), cutoff, torch.full_like(cutoff, k - 1))
        picked = csum.gather(1, cutoff[:, None])[:, 0]
        row_val = rows.gather(1, cutoff[:, None])[:, 0]
        residual = residual - (picked - row_val)           # prefix before cutoff
        group = group * k + cutoff
    leaf = torch.clamp(group, max=spec.capacity - 1)
    return leaf, tree[spec.leaf_offset + leaf]


def build(spec: SumTreeSpec, priorities: torch.Tensor) -> torch.Tensor:
    """Bulk-build a tree from a dense (capacity,) priority vector."""
    tree = init(spec, priorities.device, priorities.dtype)
    tree[spec.leaf_offset:spec.leaf_offset + spec.capacity] = priorities
    return rebuild(spec, tree)


def leaves(spec: SumTreeSpec, tree: torch.Tensor) -> torch.Tensor:
    """View of all usable leaf priorities, shape (capacity,)."""
    return tree[spec.leaf_offset:spec.leaf_offset + spec.capacity]


def check_invariant(spec: SumTreeSpec, tree: torch.Tensor, atol=1e-3) -> bool:
    """Every parent equals the sum of its children (test helper)."""
    t = tree.detach().cpu().numpy()
    for level in range(spec.leaf_level):
        lo, size = spec.offsets[level], spec.level_sizes[level]
        nxt_lo, nxt_size = spec.offsets[level + 1], spec.level_sizes[level + 1]
        groups = nxt_size // spec.fanout
        child_sums = t[nxt_lo:nxt_lo + nxt_size].reshape(groups, spec.fanout).sum(-1)
        parents = t[lo:lo + size]
        if not np.allclose(parents[:groups], child_sums, atol=atol, rtol=1e-4):
            return False
        if level == 0 and not np.allclose(parents[1:], 0.0, atol=atol):
            return False
        if not np.allclose(parents[groups:], 0.0, atol=atol):
            return False
    return True
