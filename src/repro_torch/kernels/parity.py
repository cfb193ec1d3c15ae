"""The rules each kernel is held to against its plain version.

``chip_smoke.py`` and the tests apply these same functions, so the card
and the CPU hold a kernel to one rule.

* **Sampled indices** (the sample and fused sample+gather kernels).  The
  warp scan rounds the partial sums of a sibling row in another order
  than the plain cumsum, so a draw that lies at an fp tie of two
  neighbouring leaves may land on either.  The rounding is largest at the
  top level, where the partial sums reach the total: each f32 addition
  there moves the residual by at most ulp(total)/2, and the roundings
  mostly cancel.  A draw may therefore differ only if its position
  ``clip(u)·total`` lies within ``TIE_ULPS``·ulp(total) of the boundary
  between the two leaves in the tree's own CDF (summed in f64 from the
  stored node values).  The number of such draws is bounded by the count
  that window predicts: B·window / mean leaf.  A descent that lands one
  leaf off away from a boundary, or on too many draws, fails.
* **Tree update** (the update kernel).  The kernel writes leaves with
  plain stores, so the leaf level (with the scratch slot) is held bit
  for bit.  Each interior level sums its deltas with atomics in a
  varying order and is held at rtol 1e-5 plus an atol of 1e-6 of that
  level's own largest magnitude.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from repro_torch.core.sumtree import SumTreeSpec

TIE_ULPS = 4
LEVEL_RTOL = 1e-5
LEVEL_ATOL_FRAC = 1e-6    # of the level's largest magnitude


def ulp(x: float) -> float:
    """Spacing of float32 numbers at ``x``."""
    return float(np.spacing(np.float32(abs(x))))


def leaf_start(spec: SumTreeSpec, tree: torch.Tensor, leaf: torch.Tensor
               ) -> torch.Tensor:
    """Where each leaf begins in the tree's own CDF, in f64: at every
    level, the stored values of the siblings before the leaf's ancestor."""
    k = spec.fanout
    t64 = tree.detach().double()
    lanes = torch.arange(k, device=tree.device)
    start = torch.zeros(leaf.shape, dtype=torch.float64, device=tree.device)
    node = leaf.to(torch.int64)
    for level in range(spec.leaf_level, 0, -1):
        group, lane = node // k, node % k
        row = t64[spec.offsets[level] + group[:, None] * k + lanes]
        start += torch.where(lanes < lane[:, None], row, torch.zeros_like(row)).sum(-1)
        node = group
    return start


@dataclasses.dataclass(frozen=True)
class TieReport:
    """How two sets of sampled indices differ: ``flips`` draws of
    ``draws``, against ``allowed``; the farthest flipped draw lies
    ``max_dist_ulp`` ulp(total) from its leaf boundary, against a window
    of ``window_ulp``."""

    draws: int
    flips: int
    allowed: int
    max_dist_ulp: float
    window_ulp: float

    @property
    def ok(self) -> bool:
        return self.flips <= self.allowed and self.max_dist_ulp <= self.window_ulp

    def __str__(self) -> str:
        return (f"{self.flips} of {self.draws} draws flipped (at most {self.allowed}), "
                f"farthest {self.max_dist_ulp:.3f} ulp(total) from the leaf boundary "
                f"(window {self.window_ulp:.3f})")


def sample_ties(spec: SumTreeSpec, tree: torch.Tensor, u: torch.Tensor,
                got: torch.Tensor, want: torch.Tensor, slack: float = 0.0
                ) -> TieReport:
    """Hold sampled indices ``got`` to ``want`` under the fp-tie rule.

    ``slack`` widens the window by an absolute amount, for a reference
    that scales ``u`` by a total other than the root ``tree[0]``.
    """
    total = float(tree[0])
    unit = ulp(total)
    window = TIE_ULPS * unit + slack
    draws = u.shape[0]
    mean_leaf = total / spec.capacity
    allowed = max(1, math.ceil(draws * window / mean_leaf))
    bad = got != want
    flips = int(bad.sum())
    dist = 0.0
    if flips:
        # the f32 residual both descents start from
        pos = (torch.clamp(u[bad].to(tree.dtype), 1e-12, 1.0 - 1e-7) * tree[0]).double()
        a, b = got[bad].to(torch.int64), want[bad].to(torch.int64)
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        # the draw must lie at the start of every leaf after lo up to hi:
        # the leaves between the two carry no more than the window
        far = torch.maximum((pos - leaf_start(spec, tree, lo + 1)).abs(),
                            (pos - leaf_start(spec, tree, hi)).abs())
        dist = float(far.max())
    return TieReport(draws=draws, flips=flips, allowed=allowed,
                     max_dist_ulp=dist / unit, window_ulp=window / unit)


def tree_mismatch(spec: SumTreeSpec, got: torch.Tensor, want: torch.Tensor, *,
                  exact_leaves: bool = True) -> List[str]:
    """Compare two trees level by level → a description of each level
    that disagrees (empty when they agree).

    The leaf level runs to the end of the flat array (the scratch slot
    included).  With ``exact_leaves`` it must match bit for bit; without,
    it is held like an interior level.
    """
    g, w = got.detach().cpu().double(), want.detach().cpu().double()
    problems = []
    bounds = [(spec.offsets[lv], spec.offsets[lv] + spec.level_sizes[lv])
              for lv in range(spec.leaf_level)]
    bounds.append((spec.leaf_offset, spec.total_size))
    for level, (lo, hi) in enumerate(bounds):
        gl, wl = g[lo:hi], w[lo:hi]
        err = (gl - wl).abs()
        if level == spec.leaf_level and exact_leaves:
            if not torch.equal(got[lo:hi], want[lo:hi]):
                problems.append(f"leaf level differs at {int((err > 0).sum())} slots "
                                f"(max |err| {float(err.max()):.3g}); it must be exact")
            continue
        atol = LEVEL_ATOL_FRAC * float(wl.abs().max())
        over = err > atol + LEVEL_RTOL * wl.abs()
        if bool(over.any()):
            problems.append(f"level {level}: {int(over.sum())} nodes beyond rtol {LEVEL_RTOL} "
                            f"+ atol {atol:.3g} (max |err| {float(err.max()):.3g})")
    return problems
