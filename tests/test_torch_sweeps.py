"""The planner's measurement helpers (repro_torch.runtime.sweeps) and the
live profile (planner.profile) on the CPU, against the reference's sweeps
as the reference's planner reads them.

The point dicts must carry the reference's keys letter for letter (the
key lists are written out here: this file does not import the reference's
benchmark folder, which the port may not reach either); on the same
profiled points the port's and the reference's planners must choose the
same config, field for field (exact: both are pure Python over the same
floats).  Rates are CPU timings at a few iterations: only their finiteness
and sign are held, never their values.  The shard/pod points run on
spawned gloo CPU ranks, one a mesh cell; the 1×2 mesh plan is realized on
two."""

import math

import pytest

from repro.runtime import planner as ref
from repro_torch.runtime import planner, sweeps

# benchmarks/fig9_fanout.py::executor_backend_points and
# benchmarks/fig10_scalability.py::shard_pod_points, their point keys
FIG9_KEYS = ["backend", "shards", "pods", "publish_interval", "max_staleness", "n_envs",
             "env_steps_per_s", "speedup_vs_sync", "repeats", "rel_spread"]
FIG10_KEYS = ["backend", "shards", "pods", "compressed", "n_envs", "env_steps_per_s",
              "repeats", "rel_spread"]
ITERS = 8


@pytest.fixture(scope="module")
def profiled():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sweeps, "REPEATS", 1)
        fig9 = sweeps.executor_backend_points(publish_intervals=(1, 2), n_envs=8, iters=ITERS,
                                              device="cpu")
        fig10 = sweeps.shard_pod_points(shard_counts=(1,), pod_specs=((2, 1, False),),
                                        n_envs=8, iters=ITERS, device="cpu")
    return fig9, fig10


def _positive(points):
    return all(math.isfinite(p["env_steps_per_s"]) and p["env_steps_per_s"] > 0
               for p in points)


def test_median_with_spread():
    vals = iter([3.0, 1.0, 2.0])
    assert sweeps.median_with_spread(lambda: next(vals), 3) == (2.0, 1.0)
    assert sweeps.median_with_spread(lambda: 4.0, 0) == (4.0, 0.0)
    assert sweeps.REPEATS == 3


def test_points_carry_the_reference_keys(profiled):
    fig9, fig10 = profiled
    assert [list(p) for p in fig9] == [FIG9_KEYS] * 3
    assert [list(p) for p in fig10] == [FIG10_KEYS] * 2
    assert [(p["backend"], p["publish_interval"]) for p in fig9] == [
        ("fused", 0), ("async", 1), ("async", 2)]
    assert [(p["backend"], p["shards"], p["pods"], p["compressed"]) for p in fig10] == [
        ("sharded", 1, 1, False), ("sharded_pod_data", 1, 2, False)]
    assert _positive(fig9) and _positive(fig10)
    assert {p["n_envs"] for p in fig9 + fig10} == {8}
    assert {p["repeats"] for p in fig9 + fig10} == {1}
    assert fig9[0]["speedup_vs_sync"] == 1.0


@pytest.mark.parametrize("update_interval", [1, 4])
def test_plan_on_profiled_points_matches_reference(profiled, update_interval):
    fig9, fig10 = profiled
    curves = dict(actor_curve={1: 900.0, 2: 1700.0, 4: 3000.0},
                  learner_curve={1: 400.0, 2: 800.0, 4: 1500.0})
    for kw in ({}, curves):
        got = planner.plan(fig9, fig10, total_lanes=8, update_interval=update_interval, **kw)
        want = ref.plan(fig9, fig10, total_lanes=8, update_interval=update_interval, **kw)
        assert got.to_dict() == want.to_dict()
        measured = {(p["backend"], p["env_steps_per_s"]) for p in fig9} | {
            ("sharded", p["env_steps_per_s"]) for p in fig10}
        assert (got.backend, got.predicted_env_steps_per_s) in measured


@pytest.mark.parametrize("counts", [(8, 8, 8), (8, 16), (32, 8, 16, 8)])
def test_assert_uniform_n_envs(counts):
    points = [{"n_envs": n} for n in counts]
    if len(set(counts)) == 1:
        assert sweeps.assert_uniform_n_envs(points) is points
        return
    # the reference's message, word for word
    want = (f"BENCH_fig10 points mix n_envs={sorted(set(counts))}: every point of one "
            "emitted sweep must run the same global env count — pass one n_envs through "
            "all arms (benchmarks/run.py)")
    with pytest.raises(ValueError) as err:
        sweeps.assert_uniform_n_envs(points)
    assert str(err.value) == want


@pytest.mark.parametrize("lanes", [1, 4])
def test_lane_curves_are_rates(lanes):
    a = sweeps.actor_throughput(lanes, "cpu")
    b = sweeps.learner_throughput(lanes, "cpu")
    assert math.isfinite(a) and a > 0 and math.isfinite(b) and b > 0


def test_make_runtime_executor_kinds():
    from repro_torch.runtime.executors import AsyncExecutor, FusedExecutor

    fused = sweeps.make_runtime_executor("fused", 8, 0, 0, 0, device="cpu")
    assert type(fused) is FusedExecutor and fused.n_envs == 8 and fused.scan_chunk == 20
    assert fused.replay.config.capacity == 50_000 and fused.replay.config.fanout == 128
    assert (fused.cfg.batch_size, fused.cfg.warmup, fused.cfg.epsilon) == (64, 64, 0.1)
    asy = sweeps.make_runtime_executor("async", 8, 0, 2, 0, device="cpu")
    assert type(asy) is AsyncExecutor and asy.publish_interval == 2


@pytest.mark.parametrize("n_data", [0, 2])
def test_realize_plan(n_data):
    """A fused plan is realized in this process, a 1×2 mesh plan on two
    gloo CPU ranks; both report their learner calls and a finite loss."""
    pc = planner.PlannedConfig(backend="fused" if not n_data else "sharded", n_data=n_data,
                               n_envs=8, predicted_env_steps_per_s=1.0)
    got = sweeps.realize_plan(pc, iters=ITERS, device="cpu")
    assert set(got) == {"env_steps_per_s", "learner_calls", "launches", "loss", "device"}
    assert got["device"] == "cpu" and got["learner_calls"] > 0
    assert math.isfinite(got["env_steps_per_s"]) and got["env_steps_per_s"] > 0
    assert math.isfinite(got["loss"])
    assert not any(got["launches"].values())       # the plain versions run on the CPU
    if not n_data:
        assert sweeps.plan_throughput(pc, iters=ITERS, device="cpu") > 0


def test_profile_smoke_returns_the_four_inputs(monkeypatch):
    """``profile(smoke=True)`` end to end on the CPU, its sweeps at a few
    iterations and one repeat: the reference's four keys, lane curves at
    (1, 2, 4), every point at one n_envs, and a plan from them."""
    monkeypatch.setattr(sweeps, "REPEATS", 1)
    for name in ("executor_backend_points", "shard_pod_points"):
        real = getattr(sweeps, name)
        monkeypatch.setattr(sweeps, name,
                            lambda *a, _real=real, **kw: _real(*a, **{**kw, "iters": ITERS}))
    prof = planner.profile(smoke=True, device="cpu")
    assert list(prof) == ["fig9_points", "fig10_points", "actor_curve", "learner_curve"]
    assert len(prof["fig9_points"]) == 3 and len(prof["fig10_points"]) == 3
    assert list(prof["actor_curve"]) == list(prof["learner_curve"]) == [1, 2, 4]
    sweeps.assert_uniform_n_envs(prof["fig9_points"] + prof["fig10_points"])
    assert _positive(prof["fig9_points"]) and _positive(prof["fig10_points"])
    pc = planner.plan(prof["fig9_points"], prof["fig10_points"],
                      actor_curve=prof["actor_curve"], learner_curve=prof["learner_curve"])
    assert pc.to_dict() == ref.plan(prof["fig9_points"], prof["fig10_points"],
                                    actor_curve=prof["actor_curve"],
                                    learner_curve=prof["learner_curve"]).to_dict()
