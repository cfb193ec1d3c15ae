"""The planner's measurement helpers: the sweeps that ``planner.profile``
runs to measure its inputs on this machine (paper §V-D).

The reference keeps these functions in its benchmark folder
(``benchmarks/timing.py``, ``fig9_fanout.py``, ``fig10_scalability.py``,
``fig12_dse.py``) only because its planner reuses them; the port keeps
them beside its planner and imports nothing of that folder.  Each
function's docstring names its reference.

The workload of every point is the reference's: DQN (4, 256, 256, 2) on
CartPole, replay 50,000 × K=128 (divided over the mesh cells), batch 64,
warmup 64, ε 0.1, chunks of 20 iterations.  The executor-backend points
(fused, async) run in this process; each shard/pod point runs on a fresh
mesh of ranks, one a mesh cell (``launch/mesh.py::spawn``; on one card,
ranks that time-share it over gloo).  A plan is realized the same way:
with a mesh on as many ranks, without one in this process.  Every function runs on the card unless given
``device="cpu"``; a probe ends in one synchronize of the card and none
inside its loop.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device

# repeats per point (median-of-N, benchmarks/timing.py's policy)
REPEATS = 3
SCAN_CHUNK = 20
CAPACITY = 50_000
SEED = 0


def median_with_spread(measure: Callable[[], float],
                       repeats: int = REPEATS) -> Tuple[float, float]:
    """Run ``measure`` (a warmed-up throughput probe returning a rate)
    ``repeats`` times; returns (median, rel_spread) with
    ``rel_spread = (max − min) / median`` — ``benchmarks/timing.py::
    median_with_spread``."""
    vals = [float(measure()) for _ in range(max(1, repeats))]
    med = statistics.median(vals)
    spread = (max(vals) - min(vals)) / med if med > 0 else 0.0
    return med, spread


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- executors and their rate ---------------------------------------------------


def make_runtime_executor(kind: str, n_envs: int, shards: int, publish_interval: int,
                          max_staleness: int, pods: int = 0, compress: bool = False,
                          scan_chunk: int = SCAN_CHUNK, device="cuda"):
    """Any runtime-backend executor of the sweeps' workload —
    ``benchmarks/fig9_fanout.py::_make_runtime_executor``.  ``kind`` ∈
    {fused, sharded, async}; ``shards`` is the data-axis extent (0 = no
    mesh), ``pods`` > 1 adds the slow pod axis, ``compress`` the int8-EF
    cross-pod reduce.  With a mesh this must run on each rank of a process
    group of ``max(1, pods) × shards`` ranks; it is also the generic worker
    behind a planner-chosen config (``realize_plan``)."""
    from repro_torch.launch.multiprocess import _dqn_cartpole
    from repro_torch.runtime.executors import executor_from_plan
    from repro_torch.runtime.loop import LoopConfig
    from repro_torch.runtime.planner import PlannedConfig

    plan = PlannedConfig(backend=kind, n_pods=max(1, pods), n_data=shards,
                         publish_interval=publish_interval if kind == "async" else 0,
                         max_staleness=max_staleness, compress_pod_reduce=compress,
                         n_envs=n_envs)
    env_fn, _, agent, example = _dqn_cartpole()       # the wall-clock gang's workload
    cfg = LoopConfig(batch_size=64, warmup=64, epsilon=0.1)
    return executor_from_plan(plan, agent, env_fn, cfg, example, capacity=CAPACITY,
                              fanout=128, scan_chunk=scan_chunk, device=device)


def _probe_run(ex, iters: int, repeats: Optional[int]):
    """One untimed chunk, then ``repeats`` timed probes of ``iters //
    scan_chunk`` chunks → (median env-steps/s, rel_spread, final state,
    the last chunk's metrics)."""
    st, _ = ex.run_chunk(ex.init(SEED))
    _sync(ex.device)
    n_chunks = max(1, iters // ex.scan_chunk)
    held = [st, None]

    def probe():
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            held[0], held[1] = ex.run_chunk(held[0])
        _sync(ex.device)
        return ex.n_envs * ex.scan_chunk * n_chunks / (time.perf_counter() - t0)

    med, spread = median_with_spread(probe, REPEATS if repeats is None else repeats)
    return med, spread, held[0], held[1]


def steps_per_s_stats(ex, iters: int = 120, repeats: Optional[int] = None
                      ) -> Tuple[float, float]:
    """(median env-steps/s, rel_spread) over ``repeats`` probes of one
    warmed executor — ``benchmarks/fig9_fanout.py::_steps_per_s_stats``."""
    return _probe_run(ex, iters, repeats)[:2]


def executor_backend_points(publish_intervals: Sequence[int] = (1, 2, 4), n_envs: int = 8,
                            iters: int = 120, device="cuda") -> List[dict]:
    """env-steps/s of the fused backend and of the async backend at each
    publish interval, in this process — ``benchmarks/fig9_fanout.py::
    executor_backend_points``, its keys letter for letter."""
    base, spread = steps_per_s_stats(
        make_runtime_executor("fused", n_envs, 0, 0, 0, device=device), iters)
    points = [{"backend": "fused", "shards": 0, "pods": 1, "publish_interval": 0,
               "max_staleness": 0, "n_envs": n_envs, "env_steps_per_s": round(base, 2),
               "speedup_vs_sync": 1.0, "repeats": REPEATS, "rel_spread": round(spread, 4)}]
    for p in publish_intervals:
        t, spread = steps_per_s_stats(
            make_runtime_executor("async", n_envs, 0, p, 0, device=device), iters)
        points.append({"backend": "async", "shards": 0, "pods": 1, "publish_interval": p,
                       "max_staleness": 0, "n_envs": n_envs, "env_steps_per_s": round(t, 2),
                       "speedup_vs_sync": round(t / base, 3), "repeats": REPEATS,
                       "rel_spread": round(spread, 4)})
    return points


def _point_rank(rank: int, n_pods: int, n_data: int, compress: bool, n_envs: int,
                iters: int, repeats: int, device: str) -> Tuple[float, float]:
    del rank
    ex = make_runtime_executor("sharded", n_envs, n_data, 0, 0, pods=n_pods,
                               compress=compress, device=device)
    return steps_per_s_stats(ex, iters, repeats)


def _gang_rate(n_pods: int, n_data: int, compress: bool, n_envs: int, iters: int,
               device) -> Tuple[float, float]:
    """Rank 0's (median env-steps/s, rel_spread) of ``ShardedExecutor`` on
    a fresh ``n_pods × n_data`` mesh of ranks; ``n_envs`` is the global
    env count.  The ranks take this process's ``REPEATS``."""
    from repro_torch.launch import mesh as meshlib

    return meshlib.spawn(_point_rank, n_pods * n_data, n_pods, n_data, compress, n_envs, iters,
                         REPEATS, str(device), backend="gloo", device=str(device),
                         timeout_s=600.0)[0]


def shard_pod_points(shard_counts: Sequence[int] = (1, 2),
                     pod_specs: Sequence[Tuple[int, int, bool]] = ((2, 1, False), (2, 2, False),
                                                                   (2, 2, True)),
                     n_envs: int = 16, iters: int = 120, device="cuda") -> List[dict]:
    """env-steps/s of ``ShardedExecutor`` per data-axis shard count and
    per (n_pods, n_data, compressed) pod×data mesh, each on a fresh mesh of
    ranks, one a cell — ``benchmarks/fig10_scalability.py::
    shard_pod_points``, its keys letter for letter.  ``n_envs`` is every
    point's global env count, so the points compare with each other and
    with ``executor_backend_points`` at the same count.  The ranks and the
    program are those ``realize_plan`` runs for a plan with that mesh, a
    1-shard mesh included (the reference times ``ShardedExecutor`` over a
    1-device mesh there too)."""
    resolve_device(device)
    points = []
    for n in shard_counts:
        t, spread = _gang_rate(1, n, False, n_envs, iters, device)
        points.append({"backend": "sharded", "shards": n, "pods": 1, "compressed": False,
                       "n_envs": n_envs, "env_steps_per_s": round(t, 2),
                       "repeats": REPEATS, "rel_spread": round(spread, 4)})
    for n_pods, n_data, compress in pod_specs:
        t, spread = _gang_rate(n_pods, n_data, compress, n_envs, iters, device)
        points.append({"backend": "sharded_pod_data", "shards": n_data, "pods": n_pods,
                       "compressed": bool(compress), "n_envs": n_envs,
                       "env_steps_per_s": round(t, 2), "repeats": REPEATS,
                       "rel_spread": round(spread, 4)})
    return points


def assert_uniform_n_envs(points: Sequence[dict]) -> Sequence[dict]:
    """Every point of one sweep must share its global env count: the
    planner ranks the points against each other, a like-for-like
    comparison only when each runs the same workload —
    ``benchmarks/fig10_scalability.py::assert_uniform_n_envs``."""
    counts = {p.get("n_envs") for p in points}
    if len(counts) > 1:
        raise ValueError(
            f"BENCH_fig10 points mix n_envs={sorted(counts)}: every point "
            "of one emitted sweep must run the same global env count — "
            "pass one n_envs through all arms (benchmarks/run.py)")
    return points


# -- Eq. 5's lane curves ----------------------------------------------------------


def actor_throughput(lanes: int, device="cuda") -> float:
    """Env-steps/s of 10 act + env steps of ``lanes`` CartPole envs with
    the DQN — ``benchmarks/fig12_dse.py::actor_throughput``."""
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.envs.classic import make_vec
    from repro_torch.runtime import dse

    dev = resolve_device(device)
    spec, v_reset, v_step = make_vec("cartpole", lanes)
    agent = make_dqn(spec, DQNConfig())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    agent_state = agent.init(gen)
    env_state, obs = v_reset(gen)

    def fn():
        nonlocal env_state, obs
        for _ in range(10):
            a = agent.act(agent_state, obs, gen, 0.1)
            env_state, obs, _, _, _ = v_step(env_state, a, gen)
        _sync(dev)

    return dse.measure_throughput(fn, 10 * lanes)


def learner_throughput(lanes: int, device="cuda") -> float:
    """Batch items/s of 10 DQN learn calls at batch 32 × ``lanes`` —
    ``benchmarks/fig12_dse.py::learner_throughput``."""
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.envs.classic import make_vec
    from repro_torch.runtime import dse

    dev = resolve_device(device)
    spec, _, _ = make_vec("cartpole", 1)
    agent = make_dqn(spec, DQNConfig())
    agent_state = agent.init(torch.Generator(device=dev).manual_seed(SEED))
    b = 32 * lanes
    batch = {"obs": torch.zeros((b, 4), device=dev),
             "action": torch.zeros((b,), dtype=torch.int32, device=dev),
             "reward": torch.ones((b,), device=dev),
             "next_obs": torch.zeros((b, 4), device=dev),
             "done": torch.zeros((b,), device=dev)}
    weights = torch.ones((b,), device=dev)

    def fn():
        nonlocal agent_state
        for _ in range(10):
            agent_state, _, _ = agent.learn(agent_state, batch, weights)
        _sync(dev)

    return dse.measure_throughput(fn, 10 * b)


# -- a plan, realized ---------------------------------------------------------------


def _measure_plan(plan, iters: int, device) -> Dict[str, object]:
    """This process's (or rank's) single-probe measurement of a planned
    config, as the reference's: its env-steps/s, learner calls, the replay
    kernels' launches over the run and the last chunk's loss."""
    from repro_torch.kernels import ops

    ex = make_runtime_executor(plan.backend, plan.n_envs, plan.n_data, plan.publish_interval,
                               plan.max_staleness, pods=plan.n_pods,
                               compress=plan.compress_pod_reduce, device=device)
    before = dict(ops.launch_counts)
    rate, _, state, metrics = _probe_run(ex, iters, 1)
    return {"env_steps_per_s": rate, "learner_calls": state.learn_steps,
            "launches": {k: n - before.get(k, 0) for k, n in ops.launch_counts.items()},
            "loss": float(metrics["loss"]), "device": str(ex.device)}


def _realize_rank(rank: int, plan, iters: int, device):
    del rank
    return _measure_plan(plan, iters, device)


def plan_throughput(plan, iters: int = 120, device="cuda") -> float:
    """env-steps/s of a planner-selected config, measured in this process
    or rank — ``benchmarks/fig9_fanout.py::plan_throughput``.  The port
    calls ``realize_plan``, the one entry point, which also starts a mesh
    plan's ``plan.n_devices`` ranks; this is its in-process branch."""
    return _measure_plan(plan, iters, device)["env_steps_per_s"]


def realize_plan(plan, iters: int = 120, device="cuda") -> Dict[str, object]:
    """The measured side of a plan's predicted-against-realized record —
    ``benchmarks/fig10_scalability.py::realize_plan``: without a mesh in
    this process, with one on ``plan.n_devices`` ranks of a fresh process
    group (gloo: ranks that share one card), as ``quickstart --plan`` runs
    it.  Returns rank 0's measurement: ``env_steps_per_s`` (one probe of
    ``iters`` iterations after a warm-up chunk, as the reference's),
    ``learner_calls``, the replay kernels' ``launches`` over the run, the
    last ``loss`` and the ``device``."""
    if not plan.n_data:
        return _measure_plan(plan, iters, device)
    from repro_torch.launch import mesh as meshlib

    resolve_device(device)
    return meshlib.spawn(_realize_rank, plan.n_devices, plan, iters, str(device),
                         backend="gloo", device=str(device), timeout_s=600.0)[0]
