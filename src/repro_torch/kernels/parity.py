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
  for bit.  Each interior level sums its deltas in another order than
  the plain version's ``index_add_`` (segmented scans, fixed from call
  to call; a batch past one launch's chunk adds each chunk's deltas in
  turn) and is held at rtol 1e-5 plus an atol of 1e-6 of that level's
  own largest magnitude.
* **Flash attention** (the forward kernel), against the plain version in
  f32 on the same inputs.  O in f32 within the reference's own bar, atol
  2e-6 plus rtol 1e-4 (tests/test_flash_attention.py); O in bf16 within
  one bf16 ulp of the f32 result (rounding to nearest takes half of it)
  plus that same atol 2e-6, which covers outputs near 0, where a bf16
  ulp is finer than the f32 rounding of the P·V sum; the row LSE at rtol
  1e-5 plus atol 1e-6, for rows whose LSE lies near 0 (a causal first
  row's LSE is its one score).
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
FLASH_ATOL, FLASH_RTOL = 2e-6, 1e-4
LSE_ATOL, LSE_RTOL = 1e-6, 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-3


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


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Spacing of bf16 numbers at each |x| (8 significant bits)."""
    a = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@dataclasses.dataclass
class FlashReport:
    max_abs_err: float        # O, in f32 terms
    max_ulps: float           # bf16 O: excess over the atol, in bf16 ulps (0 for f32)
    lse_max_rel: float
    o_bad: int                # elements of O outside the rule
    lse_bad: int              # rows of LSE outside the rule

    @property
    def ok(self) -> bool:
        return self.o_bad == 0 and self.lse_bad == 0


def flash_check(o: torch.Tensor, lse: torch.Tensor, o_ref: torch.Tensor,
                lse_ref: torch.Tensor) -> FlashReport:
    """Kernel (O in the inputs' dtype, LSE) against the plain version run
    in f32 on the same inputs (``o_ref``, ``lse_ref``)."""
    err = (o.float() - o_ref.float()).abs()
    ref = o_ref.float().abs()
    if o.dtype == torch.bfloat16:
        excess = (err - FLASH_ATOL).clamp_min(0) / bf16_ulp(o_ref)
        bad, ulps = int((excess > 1.0).sum()), float(excess.max())
    else:
        bad, ulps = int((err > FLASH_ATOL + FLASH_RTOL * ref).sum()), 0.0
    lerr = (lse - lse_ref).abs()
    return FlashReport(
        max_abs_err=float(err.max()), max_ulps=ulps,
        lse_max_rel=float((lerr / lse_ref.abs().clamp_min(1e-30)).max()),
        o_bad=bad, lse_bad=int((lerr > LSE_ATOL + LSE_RTOL * lse_ref.abs()).sum()))


@dataclasses.dataclass
class FlashBwdReport:
    max_abs_err: float        # over dQ, dK, dV, in f32 terms
    max_ulps: float           # bf16: the largest excess over the atol, in bf16 ulps
    bad: dict                 # {"dq"|"dk"|"dv": elements outside the rule}
    per: dict                 # {"dq"|"dk"|"dv": (max |err|, bf16 ulps beyond atol)}

    @property
    def ok(self) -> bool:
        return not any(self.bad.values())

    def __str__(self) -> str:
        return (f"outside the rule {self.bad}, max |err| {self.max_abs_err:.3g}, "
                f"{self.max_ulps:.3f} bf16 ulp beyond atol")


def flash_bwd_check(dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
                    dq_ref: torch.Tensor, dk_ref: torch.Tensor, dv_ref: torch.Tensor
                    ) -> FlashBwdReport:
    """Kernels' (dQ, dK, dV), in the inputs' dtype, against the plain
    backward run in f32 on the same inputs."""
    bad, per = {}, {}
    for name, got, ref in (("dq", dq, dq_ref), ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        ref = ref.float()
        err = (got.float() - ref).abs()
        worst, ulps = float(err.max()) if err.numel() else 0.0, 0.0
        if got.dtype == torch.bfloat16:
            excess = (err - GRAD_ATOL).clamp_min(0) / bf16_ulp(ref)
            bad[name] = int((excess > 1.0).sum())
            ulps = float(excess.max()) if excess.numel() else 0.0
        else:
            bad[name] = int((err > GRAD_ATOL + GRAD_RTOL * ref.abs()).sum())
        per[name] = (worst, ulps)
    return FlashBwdReport(max_abs_err=max(e for e, _ in per.values()),
                          max_ulps=max(u for _, u in per.values()), bad=bad, per=per)
