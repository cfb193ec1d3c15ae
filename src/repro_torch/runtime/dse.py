"""Design-space exploration (paper §V-D, Eq. 5 + Fig. 12) — a copy of
``repro.runtime.dse``, which is pure Python: the port imports nothing of
the JAX package, so it keeps its own.

Given profiled throughput curves f_a(x) (data collection vs parallelism)
and f_l(x) (data consumption vs parallelism) and a total resource budget
M, pick (x_a, x_l) with x_a + x_l ≤ M such that

    f_a(x_a) ≈ update_interval × f_l(x_l)

by the paper's exhaustive O(M²) search.  On one card the resource axis
is "parallel env/learner lanes" (the batch width of one actor or learner
call); across devices it is the actor/learner device-group split — same
equation, profiled the same way.

This module owns the 1-D lane split only.  The full-configuration
planner (executor backend × pod/data mesh × publish_interval) lives in
``runtime/planner.py`` and builds on the primitives exported here:
``hull``/``interp_hull`` (never claim throughput outside the profiled
range) and ``relative_score`` (unit-free comparison of Eq. 5 solutions
across curves that were measured in different units — e.g. env-steps/s
vs batch-items/s loaded from different BENCH json files).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Tuple


@dataclasses.dataclass
class DSEResult:
    x_actor: int
    x_learner: int
    actor_throughput: float
    learner_throughput: float
    ratio: float                 # realized collection/consumption ratio
    target_ratio: float
    ratio_error: float = 0.0     # |f_a - U·f_l| / f_a of the chosen point


def profile_curve(run_at: Callable[[int], float], xs: List[int]) -> Dict[int, float]:
    """run_at(x) → measured throughput (items/s) at parallelism x."""
    return {x: run_at(x) for x in xs}


def hull(curve: Dict[int, float]) -> Tuple[int, int]:
    """The profiled hull ``[min x, max x]`` of a throughput curve."""
    if not curve:
        raise ValueError("empty curve has no profiled hull")
    return min(curve), max(curve)


def interp_hull(curve: Dict[int, float], x: float) -> float:
    """Hull-clamped linear interpolation: ``x`` outside the profiled
    range reads the nearest hull edge instead of extrapolating — the
    "never claim throughput that was never measured" rule.  ``solve``
    reads every candidate allocation through this (its search ranges are
    clamped to the hull as well, because an allocation at an unprofiled
    parallelism level would tie the hull edge on ratio error and win the
    tie-break order dependent — the old flat-extrapolation behavior this
    replaces)."""
    lo, hi = hull(curve)
    x = min(max(x, lo), hi)
    if x in curve:
        return curve[x]
    xs = sorted(curve)
    below = max(v for v in xs if v <= x)
    above = min(v for v in xs if v >= x)
    if below == above:
        return curve[below]
    w = (x - below) / (above - below)
    return curve[below] * (1 - w) + curve[above] * w


def ratio_error(fa: float, fl: float, update_interval: float) -> float:
    """Eq. 5 residual |f_a − U·f_l| / f_a of an allocation."""
    return abs(fa - update_interval * fl) / max(fa, 1e-9)


def relative_score(res: DSEResult,
                   actor_curve: Dict[int, float],
                   learner_curve: Dict[int, float]) -> Tuple[float, float]:
    """Unit-free comparison key for an Eq. 5 solution: ``(ratio_error,
    -(f_a/max f_a + f_l/max f_l))`` — smaller is better.

    Normalizing each throughput by its own curve's maximum makes the
    tie-break meaningful when the two curves carry different units
    (env-steps/s vs batch-items/s — always the case for curves loaded
    from BENCH json), and makes scores comparable *across* solves on
    different curve pairs: the planner ranks candidate backends by this
    key, where the raw ``-(fa + fl)`` sum would be dominated by
    whichever backend's json happened to use the larger unit.
    """
    ma = max(actor_curve.values())
    ml = max(learner_curve.values())
    return (res.ratio_error,
            -(res.actor_throughput / max(ma, 1e-9)
              + res.learner_throughput / max(ml, 1e-9)))


def solve(
    actor_curve: Dict[int, float],
    learner_curve: Dict[int, float],
    total: int,
    update_interval: float = 1.0,
) -> DSEResult:
    """Exhaustive O(M²) search of Eq. 5 (paper §VI-G), clamped to the
    profiled hull: candidate allocations are restricted to parallelism
    levels inside ``[min profiled x, max profiled x]`` of each curve, so
    the solver never returns a lane count whose throughput was never
    measured (flat extrapolation used to let such points tie the ratio
    error of the hull edge and be selected by iteration order).

    Ties on ratio error are broken by *relative* combined throughput
    (``relative_score``): each curve's throughput is normalized by its
    own maximum before summing, so the tie-break is invariant to the
    units either curve was measured in.  (The raw ``-(fa + fl)`` sum it
    replaces compared env-steps/s against batch-items/s head-on: with
    curves loaded from json the larger-unit curve decided every tie.)

    Raises ``ValueError`` for an infeasible budget or empty curves — with
    ``total < 2`` the (x_a ≥ 1, x_l ≥ 1) search space is empty and there
    is no allocation to return, and a budget too small to reach both
    curves' minimum profiled parallelism has no measured allocation
    either.
    """
    if total < 2:
        raise ValueError(
            f"total={total}: the DSE needs a resource budget of at least 2 "
            "(one actor lane + one learner lane, Eq. 5 requires x_a ≥ 1 "
            "and x_l ≥ 1)")
    if not actor_curve or not learner_curve:
        raise ValueError("actor_curve and learner_curve must be non-empty "
                         "profiled throughput curves")
    a_lo, a_hi = hull(actor_curve)
    l_lo, l_hi = hull(learner_curve)
    ma = max(actor_curve.values())
    ml = max(learner_curve.values())
    best = None
    for xa in range(max(1, a_lo), min(total - 1, a_hi) + 1):
        for xl in range(max(1, l_lo), min(total - xa, l_hi) + 1):
            fa = interp_hull(actor_curve, xa)
            fl = interp_hull(learner_curve, xl)
            err = ratio_error(fa, fl, update_interval)
            # match ratio, then maximize *relative* work (unit-free)
            score = (err, -(fa / max(ma, 1e-9) + fl / max(ml, 1e-9)))
            if best is None or score < best[0]:
                best = (score, DSEResult(xa, xl, fa, fl,
                                         fa / max(fl, 1e-9), update_interval,
                                         ratio_error=err))
    if best is None:
        raise ValueError(
            f"total={total} cannot reach the profiled hull: the smallest "
            f"measured allocation is x_a={a_lo} + x_l={l_lo} = "
            f"{a_lo + l_lo} lanes — profile smaller parallelism levels or "
            "raise the budget (allocating below the profiled range would "
            "claim throughput that was never measured)")
    return best[1]


def measure_throughput(fn: Callable[[], None], items_per_call: int,
                       warmup: int = 2, iters: int = 5) -> float:
    """Host wall-clock items/s of ``fn``.  A callable that runs on the card
    must end in ``torch.cuda.synchronize()`` (the counterpart of the
    reference's ``block_until_ready``), or this times the launches only."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    return items_per_call * iters / dt
