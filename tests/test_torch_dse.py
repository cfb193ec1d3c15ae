"""The port's design-space exploration (repro_torch.runtime.dse, paper
§V-D, Eq. 5) against the reference's (repro.runtime.dse) on the same
curves: the same DSEResult field for field, the same hull interpolation
and scores, the same errors.  Both are pure Python, so every comparison
is exact.  Curves are made from a seed with numpy."""

import dataclasses

import numpy as np
import pytest

from repro.runtime import dse as ref
from repro_torch.runtime import dse


def _curves(seed: int, lanes=(1, 2, 4, 8)):
    """A saturating actor curve and a sub-linear learner curve, in
    different units (env-steps/s against batch-items/s), from ``seed``."""
    rng = np.random.RandomState(seed)
    a0, l0 = rng.uniform(50.0, 5000.0), rng.uniform(1e3, 1e6)
    sat, exp = rng.uniform(0.3, 1.0), rng.uniform(0.4, 1.1)
    actor = {x: float(a0 * x ** sat * rng.uniform(0.9, 1.1)) for x in lanes}
    learner = {x: float(l0 * x ** exp * rng.uniform(0.9, 1.1)) for x in lanes}
    return actor, learner


CASES = [(seed, total, ui) for seed in range(4) for total in (2, 5, 8, 12)
         for ui in (1.0, 4.0, 1.0 / 64.0)]


@pytest.mark.parametrize("seed,total,update_interval", CASES)
def test_solve_matches_reference(seed, total, update_interval):
    actor, learner = _curves(seed)
    got = dse.solve(actor, learner, total, update_interval)
    want = ref.solve(actor, learner, total, update_interval)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dse.relative_score(got, actor, learner) == ref.relative_score(want, actor, learner)


@pytest.mark.parametrize("lanes", [(1, 2, 4, 8), (2, 3, 7), (4,), (1, 16)])
def test_interp_hull_and_hull_match_reference(lanes):
    actor, _ = _curves(11, lanes)
    assert dse.hull(actor) == ref.hull(actor)
    for x in np.linspace(-1.0, 20.0, 85):
        assert dse.interp_hull(actor, float(x)) == ref.interp_hull(actor, float(x))
    for x in range(0, 20):
        assert dse.interp_hull(actor, x) == ref.interp_hull(actor, x)


def test_ratio_error_matches_reference():
    rng = np.random.RandomState(3)
    for fa, fl, u in rng.uniform(0.0, 1e4, size=(200, 3)):
        assert dse.ratio_error(fa, fl, u) == ref.ratio_error(fa, fl, u)
    assert dse.ratio_error(0.0, 1.0, 1.0) == ref.ratio_error(0.0, 1.0, 1.0)


def _error(mod, *args):
    with pytest.raises(ValueError) as e:
        mod.solve(*args)
    return str(e.value)


@pytest.mark.parametrize("args", [
    ({1: 1.0}, {1: 1.0}, 1),                       # budget below 2
    ({}, {1: 1.0}, 4),                             # empty curve
    ({1: 1.0}, {}, 4),
    ({4: 10.0, 8: 20.0}, {4: 5.0, 8: 9.0}, 6),     # off the profiled hull
])
def test_solve_errors_match_reference(args):
    assert _error(dse, *args) == _error(ref, *args)
    with pytest.raises(ValueError, match="empty curve"):
        dse.hull({})


def test_profile_curve_and_measure_throughput():
    calls = []

    def run_at(x):
        calls.append(x)
        return 10.0 * x

    assert dse.profile_curve(run_at, [1, 2, 4]) == ref.profile_curve(run_at, [1, 2, 4])
    assert calls == [1, 2, 4] * 2
    ticks = []
    rate = dse.measure_throughput(lambda: ticks.append(1), 32, warmup=2, iters=5)
    assert len(ticks) == 7 and rate > 0.0
