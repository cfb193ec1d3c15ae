"""The port's configuration planner (repro_torch.runtime.planner) against
the reference's (repro.runtime.planner) on the same inputs — ports of
tests/test_planner.py's planner tests — and the plan-to-executor path
(``executor_from_plan``, ``mesh_from_plan``) on the CPU.

Tolerances: exact everywhere.  Both planners are pure Python over the
same floats, so plans, lane splits, candidates and errors must be equal
field for field; ``plan_from_json`` reads copies of the committed
BENCH_fig9/fig10/serve json (read, never written).  The executors built
from a plan are held to the reference's classes and env-step counts
(JAX's and torch's random streams differ, so only the counts compare).
The sharded plans run on gloo ranks spawned here (launch/mesh.py::spawn);
the rank functions live in this module, so JAX is imported inside the
tests only.
"""

import dataclasses
import functools
import json
import math
import shutil
from pathlib import Path

import pytest
import torch

from repro.runtime import planner as ref
from repro_torch.agents.dqn import DQNConfig, make_dqn
from repro_torch.core.distributed import ShardedPrioritizedReplay, ShardedReplayConfig
from repro_torch.envs.classic import make_vec
from repro_torch.launch import mesh as meshlib
from repro_torch.quickstart import transition_example
from repro_torch.runtime import planner
from repro_torch.runtime.executors import AsyncExecutor, FusedExecutor, executor_from_plan
from repro_torch.runtime.loop import LoopConfig, RatioSchedule

REPO = Path(__file__).resolve().parents[1]
BENCH = ("BENCH_fig9.json", "BENCH_fig10.json", "BENCH_serve.json")
CARTPOLE = functools.partial(make_vec, "cartpole")
SMALL = LoopConfig(batch_size=32, warmup=0, epsilon=0.3)


def _fig9_point(backend="fused", shards=0, publish_interval=0, n_envs=8, steps=1000.0):
    return {"backend": backend, "shards": shards, "pods": 1,
            "publish_interval": publish_interval, "max_staleness": 0,
            "n_envs": n_envs, "env_steps_per_s": steps, "speedup_vs_sync": 1.0}


def _fig10_point(shards, pods=1, compressed=False, steps=1000.0, n_envs=16):
    backend = "sharded_pod_data" if pods > 1 else "sharded"
    return {"backend": backend, "shards": shards, "pods": pods,
            "compressed": compressed, "n_envs": n_envs, "env_steps_per_s": steps}


def _wallclock_point(procs=2, pods=1, shards=2, publish=0, overlapped=False,
                     compressed=False, ui=None, steps=1000.0, n_envs=16):
    p = {"backend": "wallclock", "n_procs": procs, "pods": pods, "shards": shards,
         "publish_interval": publish, "overlapped": overlapped, "compressed": compressed,
         "n_envs": n_envs, "env_steps_per_s": steps}
    if ui is not None:
        p["update_interval"] = ui
    return p


def _serve_point(writers=2, n_shards=1, inserts=2000.0, samples=16000.0, spi=8.0, batch=64):
    return {"writers": writers, "n_shards": n_shards, "spi": spi, "batch_size": batch,
            "inserts_per_s": inserts, "samples_per_s": samples, "realized_spi": spi,
            "repeats": 3, "rel_spread": 0.01}


def _same(fn_port, fn_ref):
    """Both calls' results, or both calls' ValueErrors, as comparable values."""
    out = []
    for fn in (fn_port, fn_ref):
        try:
            res = fn()
            out.append(res.to_dict() if hasattr(res, "to_dict") else res)
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


# -- the plan on the same measured points ----------------------------------------

ACTOR = {x: 50.0 * x for x in (1, 2, 4, 8)}
LEARNER = {x: 120.0 * x ** 0.7 for x in (1, 2, 4, 8)}
SCENARIOS = {
    "faster async": ([_fig9_point("fused", steps=1000.0),
                      _fig9_point("async", publish_interval=2, steps=1400.0)], [], {}),
    "device budget": ([_fig9_point("fused", steps=800.0)],
                      [_fig10_point(4, steps=3000.0), _fig10_point(2, steps=1500.0)],
                      {"max_devices": 2}),
    "aliasing refused": ([_fig9_point("async", shards=4, publish_interval=4, steps=5000.0),
                          _fig9_point("fused", steps=900.0)], [],
                         {"update_interval": 32, "max_staleness": 0}),
    "lanes ride along": ([_fig9_point("fused")], [],
                         {"actor_curve": ACTOR, "learner_curve": LEARNER, "total_lanes": 8}),
    "wall-clock shadows emulated": ([], [_fig10_point(2, steps=5000.0),
                                         _wallclock_point(steps=1200.0)], {}),
    "wall-clock ratio filter": ([], [_wallclock_point(ui=8, steps=9000.0),
                                     _wallclock_point(pods=2, shards=1, overlapped=True,
                                                      compressed=True, ui=1, steps=800.0)],
                                {"update_interval": 1}),
    "pods compressed": ([], [_fig10_point(2, pods=2, compressed=True, steps=4000.0)], {}),
    "serve stage": ([_fig9_point("fused", steps=1000.0)], [],
                    {"serve_points": [_serve_point(n_shards=2, inserts=4000.0, samples=32000.0)],
                     "update_interval": 8}),
    "curves only": ([], [], {"actor_curve": ACTOR, "learner_curve": LEARNER}),
    "nothing feasible": ([_fig9_point("fused")], [_fig10_point(8, steps=1.0)],
                         {"batch_size": 3}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_plan_matches_reference(name):
    fig9, fig10, kw = SCENARIOS[name]
    got, want = _same(lambda: planner.plan(fig9, fig10, **kw),
                      lambda: ref.plan(fig9, fig10, **kw))
    assert got == want


def test_plan_matches_reference_property():
    """The reference's hypothesis strategy (tests/test_planner.py): whatever
    the measured points and knobs, the port returns the reference's plan (or
    its error), and the plan is instantiable — a measured config inside the
    lane budget, envs dividing over shards, the async aliasing rule held."""
    hypothesis = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hypothesis.settings(max_examples=80, deadline=None)
    @hypothesis.given(
        steps=st.lists(st.floats(1.0, 1e6), min_size=1, max_size=6),
        publish=st.lists(st.integers(1, 8), min_size=1, max_size=4),
        shards=st.lists(st.sampled_from([1, 2, 4, 8]), min_size=1, max_size=4),
        update_interval=st.integers(1, 64),
        max_staleness=st.integers(0, 3),
        total=st.integers(2, 12),
    )
    def check(steps, publish, shards, update_interval, max_staleness, total):
        fig9 = [_fig9_point("fused", steps=steps[0])]
        fig9 += [_fig9_point("async", shards=s, publish_interval=p,
                             steps=steps[(i + 1) % len(steps)])
                 for i, (p, s) in enumerate(zip(publish, [0] + shards))]
        fig10 = [_fig10_point(s, steps=steps[i % len(steps)]) for i, s in enumerate(shards)]
        kw = dict(actor_curve=ACTOR, learner_curve=LEARNER, total_lanes=total,
                  update_interval=update_interval, max_staleness=max_staleness)
        got, want = _same(lambda: planner.plan(fig9, fig10, **kw),
                          lambda: ref.plan(fig9, fig10, **kw))
        assert got == want
        if isinstance(got, tuple):
            assert "no feasible" in got[1] or "total=" in got[1]
            return
        pc = planner.PlannedConfig.from_dict(got)
        if pc.x_actor:
            assert pc.x_actor + pc.x_learner <= total
            assert 1 <= pc.x_actor <= 8 and 1 <= pc.x_learner <= 8
        cands = planner.candidates_from_points(fig9, fig10)
        assert any(c.backend == pc.backend and c.n_pods == pc.n_pods
                   and c.n_data == pc.n_data and c.publish_interval == pc.publish_interval
                   for c in cands)
        assert pc.n_envs % pc.n_shards == 0
        period = planner.learn_period(pc.update_interval, pc.n_envs)
        assert planner.aliasing_ok(pc.publish_interval, period, pc.n_shards, pc.max_staleness)
        if pc.publish_interval and pc.n_shards > 1:
            assert min(math.gcd(pc.publish_interval, period), pc.n_shards) <= pc.max_staleness + 1

    check()


@pytest.mark.parametrize("kw", [{}, {"update_interval": 4}, {"update_interval": 8},
                                {"max_devices": 1}, {"max_devices": 2, "max_staleness": 0},
                                {"batch_size": 48}],
                         ids=["default", "ui4", "ui8", "1dev", "2dev-s0", "b48"])
def test_plan_from_committed_bench_json(tmp_path, kw):
    for name in BENCH:
        shutil.copy(REPO / name, tmp_path / name)
    got, want = _same(lambda: planner.plan_from_json(str(tmp_path), **kw),
                      lambda: ref.plan_from_json(str(tmp_path), **kw))
    assert got == want
    assert planner.merge_bench_points(str(tmp_path)) == ref.merge_bench_points(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="emit-json"):
        planner.plan_from_json(str(tmp_path / "nope"))


def test_candidates_and_service_selection_match_reference():
    fig9 = [_fig9_point("fused"), _fig9_point("async", shards=2, publish_interval=3),
            _fig9_point("mystery")]
    fig10 = [_fig10_point(2), _fig10_point(2, pods=2, compressed=True),
             _wallclock_point(), _wallclock_point(procs=1, pods=1, shards=1, publish=2, ui=4),
             {"backend": "future", "env_steps_per_s": 1.0}]
    assert ([dataclasses.asdict(c) for c in planner.candidates_from_points(fig9, fig10)]
            == [dataclasses.asdict(c) for c in ref.candidates_from_points(fig9, fig10)])
    pts = [_serve_point(n_shards=1, inserts=2000.0, samples=16000.0),
           _serve_point(n_shards=2, inserts=4000.0, samples=32000.0),
           _serve_point(n_shards=3, inserts=9000.0, samples=72000.0)]
    for rate in (1.0, 1000.0, 3000.0, 5000.0):
        for ui in (1, 8):
            kw = dict(insert_rate=rate, update_interval=ui, batch_size=64)
            assert (planner.select_replay_service(pts, **kw)
                    == ref.select_replay_service(pts, **kw))
    curves = {"good": ({1: 100.0, 2: 200.0, 4: 400.0}, {1: 100.0, 2: 200.0, 4: 400.0}),
              "bloated": ({1: 100.0, 2: 200.0, 4: 400.0}, {1: 9.9e6, 2: 9.95e6, 4: 1e7})}
    name, res = planner.solve_backend_curves(curves, total=8)
    rname, rres = ref.solve_backend_curves(curves, total=8)
    assert name == rname == "good" and dataclasses.asdict(res) == dataclasses.asdict(rres)
    a = planner.solve_lanes(ACTOR, LEARNER, total=8, update_interval=4.0)
    assert dataclasses.asdict(a) == dataclasses.asdict(
        ref.solve_lanes(ACTOR, LEARNER, total=8, update_interval=4.0))


def test_learn_period_matches_ratio_schedule_and_reference():
    for u in (1, 2, 4, 8, 16, 32, 100):
        for e in (1, 2, 4, 8, 16):
            sched = RatioSchedule.from_config(LoopConfig(update_interval=u), e)
            assert planner.learn_period(u, e) == ref.learn_period(u, e) == sched.period


def test_aliasing_ok_matches_async_executor_refusal():
    """``aliasing_ok`` is the rule ``AsyncExecutor`` on a mesh refuses by:
    constructed on a shape-only mesh (no process group needed), it raises
    exactly where the planner says no."""
    spec, _, _ = CARTPOLE(1)
    agent = make_dqn(spec, DQNConfig(hidden=(8,)))
    replay = ShardedPrioritizedReplay(ShardedReplayConfig(capacity_per_shard=64, fanout=8),
                                      transition_example(spec), device="cpu")
    n_envs, checked = 8, 0
    for shards in (2, 4, 8):
        for publish in (1, 2, 3, 4, 6, 8):
            for ui in (1, 8, 16, 32, 48):
                for staleness in (0, 1, 2):
                    period = planner.learn_period(ui, n_envs)
                    ok = planner.aliasing_ok(publish, period, shards, staleness)
                    assert ok == ref.aliasing_ok(publish, period, shards, staleness)
                    make = functools.partial(
                        AsyncExecutor, agent, replay, CARTPOLE,
                        LoopConfig(batch_size=64, update_interval=ui), n_envs,
                        publish_interval=publish, max_staleness=staleness,
                        mesh=meshlib.Mesh(("data",), (shards,)), device="cpu")
                    if ok:
                        make()
                    else:
                        with pytest.raises(ValueError, match="share the factor"):
                            make()
                    checked += 1
    assert checked == 270


BAD_CONFIGS = [dict(backend="nope"), dict(backend="async"),
               dict(backend="fused", publish_interval=2), dict(backend="sharded"),
               dict(backend="fused", n_data=2),
               dict(backend="sharded", n_data=2, compress_pod_reduce=True),
               dict(backend="sharded", n_pods=2, n_data=1, overlap_pod_reduce=True),
               dict(backend="sharded", n_data=3, n_envs=8),
               dict(backend="fused", n_replay_shards=-1),
               dict(backend="fused", samples_per_insert=4.0),
               dict(backend="fused", n_replay_shards=1, samples_per_insert=-1.0)]


@pytest.mark.parametrize("kw", BAD_CONFIGS, ids=[str(i) for i in range(len(BAD_CONFIGS))])
def test_planned_config_validation_matches_reference(kw):
    got, want = _same(lambda: planner.PlannedConfig(**kw), lambda: ref.PlannedConfig(**kw))
    assert got[0] == "ValueError" and got == want


def test_save_load_round_trip_both_ways(tmp_path):
    pc = planner.PlannedConfig(backend="async", n_pods=2, n_data=2, publish_interval=3,
                               max_staleness=1, compress_pod_reduce=True, n_envs=8,
                               update_interval=4, x_actor=3, x_learner=5, n_replay_shards=0,
                               predicted_env_steps_per_s=950.5, source="test")
    path = tmp_path / planner.PLAN_JSON
    payload = planner.save_plan(pc, str(path), realized_env_steps_per_s=900.0,
                                curves={"actor": {"1": 1.0}})
    assert payload["config"] == pc.to_dict() and payload["realized_env_steps_per_s"] == 900.0
    assert planner.load_plan(str(path)) == pc
    assert ref.load_plan(str(path)).to_dict() == pc.to_dict()
    ref_path = tmp_path / "ref.json"
    ref.save_plan(ref.PlannedConfig(**pc.to_dict()), str(ref_path), realized_env_steps_per_s=900.0,
                  curves={"actor": {"1": 1.0}})
    assert ref_path.read_text() == path.read_text()
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(pc.to_dict()))
    assert planner.load_plan(str(bare)) == pc
    assert pc.describe() == ref.PlannedConfig(**pc.to_dict()).describe()
    with pytest.raises(ValueError, match="unknown PlannedConfig fields"):
        planner.PlannedConfig.from_dict(dict(pc.to_dict(), mystery=1))


@pytest.mark.parametrize("smoke", [True, False])
def test_profile_returns_points_at_the_reference_sizes(monkeypatch, smoke):
    """``profile`` returns what its sweeps measured, under the reference's
    four keys, and asks them for the reference's sizes: smoke publish
    intervals (1, 2), shards (1, 2), pods ((2, 1, False),), 40 iterations
    and lanes (1, 2, 4); full the sweeps' defaults at 16 envs and lanes
    (1, 2, 4, 8).  The sweeps are stubs here (tests/test_torch_sweeps.py
    runs them); every call goes to the device asked for."""
    from repro_torch.runtime import sweeps

    calls = {}

    def stub(name, out):
        def fn(*args, **kw):
            calls.setdefault(name, []).append((args, kw))
            return out(*args) if callable(out) else out
        monkeypatch.setattr(sweeps, name, fn)

    fig9, fig10 = [_fig9_point(n_envs=8)], [_fig10_point(2, n_envs=8)]
    stub("executor_backend_points", fig9)
    stub("shard_pod_points", fig10)
    stub("actor_throughput", lambda x, device: 100.0 * x)
    stub("learner_throughput", lambda x, device: 40.0 * x)
    prof = planner.profile(smoke=smoke, device="cpu")
    lanes = [1, 2, 4] if smoke else [1, 2, 4, 8]
    assert prof == {"fig9_points": fig9, "fig10_points": fig10,
                    "actor_curve": {x: 100.0 * x for x in lanes},
                    "learner_curve": {x: 40.0 * x for x in lanes}}
    want9 = (dict(publish_intervals=(1, 2), n_envs=8, iters=40) if smoke
             else dict(n_envs=16))
    want10 = (dict(shard_counts=(1, 2), pod_specs=((2, 1, False),), n_envs=8, iters=40)
              if smoke else dict(n_envs=16))
    assert calls["executor_backend_points"] == [((), dict(want9, device="cpu"))]
    assert calls["shard_pod_points"] == [((), dict(want10, device="cpu"))]
    assert [a for a, _ in calls["actor_throughput"]] == [(x, "cpu") for x in lanes]
    assert [a for a, _ in calls["learner_throughput"]] == [(x, "cpu") for x in lanes]


# -- plan → executor ---------------------------------------------------------------


def _ref_agent():
    import jax.numpy as jnp

    from repro.agents.dqn import DQNConfig as RefDQNConfig, make_dqn as ref_make_dqn
    from repro.envs.classic import make_vec as ref_make_vec

    env_fn = functools.partial(ref_make_vec, "cartpole")
    spec, _, _ = env_fn(1)
    example = {"obs": jnp.zeros((spec.obs_dim,), jnp.float32),
               "action": jnp.zeros((), jnp.int32), "reward": jnp.zeros(()),
               "next_obs": jnp.zeros((spec.obs_dim,), jnp.float32), "done": jnp.zeros(())}
    return ref_make_dqn(spec, RefDQNConfig()), env_fn, example


def _ref_run(pc_kw, cfg_kw, iters):
    """The reference's executor from the same plan: (class name, n_envs,
    update_interval, its env steps after ``iters`` iterations)."""
    import jax

    from repro.runtime.executors import executor_from_plan as ref_executor_from_plan
    from repro.runtime.loop import LoopConfig as RefLoopConfig

    agent, env_fn, example = _ref_agent()
    ex = ref_executor_from_plan(ref.PlannedConfig(**pc_kw), agent, env_fn,
                                RefLoopConfig(**cfg_kw), example)
    _, hist = ex.train(iters, jax.random.PRNGKey(0))
    return type(ex).__name__, ex.n_envs, ex.cfg.update_interval, int(hist["env_steps"][-1])


def _port_run(pc_kw, cfg_kw, iters, mesh_ok=False):
    spec, _, _ = CARTPOLE(1)
    ex = executor_from_plan(planner.PlannedConfig(**pc_kw), make_dqn(spec, DQNConfig()),
                            CARTPOLE, LoopConfig(**cfg_kw), transition_example(spec),
                            device="cpu")
    _, hist = ex.train(iters, 0)
    return type(ex).__name__, ex.n_envs, ex.cfg.update_interval, int(hist["env_steps"][-1]), ex


SMALL_KW = dict(batch_size=32, warmup=0, epsilon=0.3)


@pytest.mark.parametrize("pc_kw,cfg_kw,iters,want", [
    (dict(backend="fused", n_envs=4, update_interval=4), SMALL_KW, 16, 64),
    (dict(backend="async", publish_interval=3, max_staleness=0, n_envs=4), SMALL_KW, 16, 64),
    (dict(backend="fused", n_envs=4, update_interval=4, n_replay_shards=2,
          samples_per_insert=8.0), dict(SMALL_KW, warmup=64), 48, 192),
], ids=["fused", "async", "service"])
def test_executor_from_plan_matches_reference(pc_kw, cfg_kw, iters, want):
    name, n_envs, ui, steps, ex = _port_run(pc_kw, cfg_kw, iters)
    assert (name, n_envs, ui, steps) == _ref_run(pc_kw, cfg_kw, iters)
    assert steps == want
    if pc_kw["backend"] == "async":
        assert isinstance(ex, AsyncExecutor) and ex.publish_interval == 3
    if pc_kw.get("n_replay_shards"):
        assert ex.n_shards == 2 and ex.limiter.samples_per_insert == 8.0
    elif pc_kw["backend"] == "fused":
        assert isinstance(ex, FusedExecutor) and ex.cfg.update_interval == 4


def test_executor_from_plan_refuses_mesh_with_service_and_cast_without_mesh():
    spec, _, _ = CARTPOLE(1)
    agent, example = make_dqn(spec, DQNConfig(hidden=(8,))), transition_example(spec)
    pc = planner.PlannedConfig(backend="sharded", n_data=1, n_envs=4, n_replay_shards=1)
    with pytest.raises(ValueError, match="mesh"):
        executor_from_plan(pc, agent, CARTPOLE, SMALL, example, device="cpu")
    with pytest.raises(ValueError, match="intra_pod_dtype"):
        executor_from_plan(planner.PlannedConfig(backend="fused"), agent, CARTPOLE, SMALL,
                           example, intra_pod_dtype="bf16", device="cpu")


def test_mesh_from_plan_needs_a_process_group():
    assert meshlib.mesh_from_plan(planner.PlannedConfig(backend="fused")) is None
    assert meshlib.mesh_from_plan(planner.PlannedConfig(backend="async",
                                                        publish_interval=2)) is None
    with pytest.raises(RuntimeError, match="process group"):
        meshlib.mesh_from_plan(planner.PlannedConfig(backend="sharded", n_data=1))


def _plan_world(rank: int) -> dict:
    """Every rank: the meshes of 1-D and pod×data plans over this group, and
    the executors of a sharded and an async-on-mesh plan, trained 8
    iterations."""
    world = torch.distributed.get_world_size()
    out = {"meshes": []}
    plans = ([planner.PlannedConfig(backend="sharded", n_data=1, n_envs=4)] if world == 1 else
             [planner.PlannedConfig(backend="sharded", n_data=2, n_envs=4),
              planner.PlannedConfig(backend="sharded", n_pods=2, n_data=1, n_envs=4)])
    for pc in plans:
        m = meshlib.mesh_from_plan(pc)
        out["meshes"].append((m.axis_names, m.axis_sizes, m.n_shards, m.shard_id))
    if world == 2:
        plans.append(planner.PlannedConfig(backend="async", n_pods=2, n_data=1,
                                           publish_interval=3, max_staleness=1,
                                           compress_pod_reduce=True, n_envs=4))
    spec, _, _ = CARTPOLE(1)
    out["runs"] = []
    for pc in plans:
        agent = make_dqn(spec, DQNConfig(hidden=(32, 32)))
        ex = executor_from_plan(pc, agent, CARTPOLE, SMALL, transition_example(spec),
                                device="cpu")
        _, hist = ex.train(8, 0)
        out["runs"].append((type(ex).__name__, ex.n_shards, ex.n_envs_local,
                            int(hist["env_steps"][-1]), bool(torch.isfinite(hist["loss"]).all())))
    return out


def test_executor_and_mesh_from_plan_on_one_rank():
    """The reference's single-device sharded plan: a 1-shard data mesh, its
    env steps after 8 iterations those of the reference."""
    got = meshlib.spawn(_plan_world, 1, backend="gloo", device="cpu", timeout_s=300)[0]
    assert got["meshes"] == [(("data",), (1,), 1, 0)]
    want = _ref_run(dict(backend="sharded", n_data=1, n_envs=4), SMALL_KW, 8)
    assert want[0] == "ShardedExecutor" and want[3] == 32
    assert got["runs"] == [("ShardedExecutor", 1, 4, 32, True)]


def test_executor_and_mesh_from_plan_on_two_ranks():
    out = meshlib.spawn(_plan_world, 2, backend="gloo", device="cpu", timeout_s=300)
    for rank, got in enumerate(out):
        assert got["meshes"] == [(("data",), (2,), 2, rank), (("pod", "data"), (2, 1), 2, rank)]
        assert got["runs"] == [("ShardedExecutor", 2, 2, 32, True),
                               ("ShardedExecutor", 2, 2, 32, True),
                               ("AsyncExecutor", 2, 2, 32, True)]


def test_quickstart_trains_from_a_two_shard_plan(tmp_path, capfd):
    """The acceptance path of tests/test_planner.py: a saved 2-shard plan
    drives ``python -m repro_torch.quickstart --plan`` into the sharded
    executor on 2 gloo ranks, 48 iterations."""
    from repro_torch import quickstart

    pc = planner.PlannedConfig(backend="sharded", n_data=2, n_envs=8, update_interval=1,
                               predicted_env_steps_per_s=1234.0, source="test")
    planner.save_plan(pc, str(tmp_path / "BENCH_plan.json"))
    summary, hist = quickstart.main(["--plan", str(tmp_path / "BENCH_plan.json"),
                                     "--iterations", "48", "--device", "cpu"])
    out = capfd.readouterr().out
    assert "planner-selected sharded executor on 2 device(s), 8 envs" in out
    assert "final mean episode return" in out
    assert summary["env_steps"] == 48 * 8 and len(hist["loss"]) == 1
