"""Quickstart: the paper end to end — parallel actors, K-ary sum-tree
prioritized replay and DDQN learners on CartPole, through the fused
executor, the async one (actors on a parameter copy republished every
``--publish-interval`` iterations), or the sharded one: ``--shards``
replay/learner shards (times ``--pods``), one process each, spawned on
``--device`` through ``launch/mesh.py::spawn``.  The port's counterpart
of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.quickstart [--iterations 3000]
    PYTHONPATH=src python -m repro_torch.quickstart --backend torch     # plain ops
    PYTHONPATH=src python -m repro_torch.quickstart --fused-sample-gather
    PYTHONPATH=src python -m repro_torch.quickstart --eager-replay
    PYTHONPATH=src python -m repro_torch.quickstart --executor async --publish-interval 4
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu --iterations 512

    # 2 shards, each a process on the one card, over gloo
    PYTHONPATH=src python -m repro_torch.quickstart --shards 2 --n-envs 8 --iterations 1400
    # 2×2 (pod × data): f32 inside a pod, int8 error feedback across pods
    PYTHONPATH=src python -m repro_torch.quickstart --pods 2 --shards 2 --compress-pod-reduce
    # sharded async: staggered shard clocks, staleness-weighted reduce
    PYTHONPATH=src python -m repro_torch.quickstart --executor async --shards 4 \\
        --publish-interval 4 --max-staleness 1

    # the run a runtime/planner.py plan selected (executor_from_plan); a
    # plan with a mesh runs on plan.n_devices ranks
    PYTHONPATH=src python -m repro_torch.quickstart --plan BENCH_plan.json

Several ranks on one card need ``--backend-dist gloo`` (the default),
which stages the collectives through host memory; NCCL needs a card per
rank, so it takes one shard here.
"""

from __future__ import annotations

import argparse
import functools
import time

import torch

from repro_torch.agents.dqn import DQNConfig, make_dqn
from repro_torch.core.distributed import ShardedPrioritizedReplay, ShardedReplayConfig
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
from repro_torch.device import resolve_device
from repro_torch.envs.classic import make_vec
from repro_torch.launch import mesh as meshlib
from repro_torch.runtime.executors import (AsyncExecutor, FusedExecutor, ShardedExecutor,
                                           executor_from_plan)
from repro_torch.runtime.loop import LoopConfig
from repro_torch.runtime.planner import load_plan


def transition_example(spec) -> dict:
    """One replay item: a discrete env's action is an int32 scalar, a
    continuous env's an f32 (action_dim,) row."""
    return {
        "obs": torch.zeros((spec.obs_dim,), dtype=torch.float32),
        "action": (torch.zeros((), dtype=torch.int32) if spec.discrete
                   else torch.zeros((spec.action_dim,), dtype=torch.float32)),
        "reward": torch.zeros((), dtype=torch.float32),
        "next_obs": torch.zeros((spec.obs_dim,), dtype=torch.float32),
        "done": torch.zeros((), dtype=torch.float32),
    }


def _setup(args):
    env_fn = functools.partial(make_vec, "cartpole")
    spec, _, _ = env_fn(1)
    agent = make_dqn(spec, DQNConfig(double_q=True))
    cfg = LoopConfig(batch_size=64, warmup=500, epsilon=0.15,
                     update_interval=args.update_interval,
                     lazy_replay=not args.eager_replay)
    return env_fn, spec, agent, cfg


def _train(ex, args, log: bool):
    if log:
        print(f"ratio schedule: {ex.schedule} "
              f"(realized {ex.schedule.realized_ratio:.1f} env steps per learn)")
    t0 = time.perf_counter()
    state, hist = ex.train(args.iterations, args.seed, log_every=256 if log else 0)
    secs = time.perf_counter() - t0
    if log:
        print(f"\n{state.env_steps} env steps, {state.learn_steps} learner calls "
              f"in {secs:.1f} s ({state.env_steps / secs:,.0f} env-steps/s)")
        print("final mean episode return: "
              f"{float(hist['mean_episode_return'][-1]):.1f} "
              "(CartPole solved ≈ 475; random ≈ 10)")
    return state, hist


def _sharded_rank(rank: int, args: argparse.Namespace):
    """One shard of the quickstart, on a rank of ``launch/mesh.py::spawn``."""
    env_fn, spec, agent, cfg = _setup(args)
    if args.pods:
        mesh = meshlib.pod_data_mesh(args.pods, args.shards)
        axis_names = ("pod", "data")
    else:
        mesh = meshlib.data_mesh(args.shards)
        axis_names = ("data",)
    n_cells = mesh.n_shards
    replay = ShardedPrioritizedReplay(
        ShardedReplayConfig(capacity_per_shard=50_000 // n_cells, fanout=args.fanout,
                            backend=args.backend,
                            fused_sample_gather=args.fused_sample_gather,
                            axis_names=axis_names),
        transition_example(spec), device=args.device)
    mesh_desc = (f"{args.pods}×{args.shards} pod×data cells" if args.pods
                 else f"{args.shards} shards")
    fast_dtype = "bf16" if args.bf16_intra_pod else "f32"
    reduce_desc = (f"{fast_dtype} intra-pod + int8-EF cross-pod"
                   if args.compress_pod_reduce else f"{fast_dtype} pmean")
    intra_pod_dtype = "bf16" if args.bf16_intra_pod else None
    if args.executor == "async":
        ex = AsyncExecutor(agent, replay, env_fn, cfg, args.n_envs,
                           publish_interval=args.publish_interval,
                           max_staleness=args.max_staleness, mesh=mesh,
                           compress_pod_reduce=args.compress_pod_reduce,
                           intra_pod_dtype=intra_pod_dtype, device=args.device)
        desc = (f"async sharded executor: {mesh_desc} × {ex.n_envs_local} envs, publish "
                f"every {args.publish_interval} iters, max staleness "
                f"{args.max_staleness}, reduce {reduce_desc}")
    else:
        ex = ShardedExecutor(agent, replay, env_fn, cfg, args.n_envs, mesh,
                             compress_pod_reduce=args.compress_pod_reduce,
                             intra_pod_dtype=intra_pod_dtype, device=args.device)
        desc = (f"sharded executor: {mesh_desc} × {ex.n_envs_local} envs, batch/shard "
                f"{cfg.batch_size // n_cells}, reduce {reduce_desc}")
    if rank == 0:
        print(f"{desc} ({args.backend_dist} on {ex.device}, tree backend "
              f"{replay.ops.name})", flush=True)
    state, hist = _train(ex, args, log=rank == 0)
    return ({"env_steps": state.env_steps, "learn_steps": state.learn_steps,
             "params_age": state.params_age}, hist)


def _planned(rank: int, args: argparse.Namespace, plan):
    """The run a plan selected, through ``executor_from_plan``: in this
    process, or on a rank of ``launch/mesh.py::spawn`` when it has a mesh."""
    env_fn, spec, agent, cfg = _setup(args)
    ex = executor_from_plan(plan, agent, env_fn, cfg, transition_example(spec),
                            fanout=args.fanout, tree_backend=args.backend,
                            intra_pod_dtype="bf16" if args.bf16_intra_pod else None,
                            device=args.device)
    if rank == 0:
        print(f"planner-selected {plan.backend} executor on {plan.n_devices} device(s), "
              f"{plan.n_envs} envs (predicted {plan.predicted_env_steps_per_s:,.0f} "
              f"env-steps/s; {type(ex).__name__} on {ex.device})", flush=True)
    state, hist = _train(ex, args, log=rank == 0)
    if plan.n_data:
        return ({"env_steps": state.env_steps, "learn_steps": state.learn_steps,
                 "params_age": state.params_age}, hist)
    return state, hist


def main(argv=None):
    """Returns (state, history); with ``--shards`` or a plan with a mesh,
    rank 0's (summary of its state, history)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plan", default=None, metavar="BENCH_plan.json",
                    help="run the executor a runtime.planner plan selected "
                         "(overrides --shards/--pods/--executor/--publish-interval/"
                         "--max-staleness/--n-envs/--update-interval)")
    ap.add_argument("--iterations", type=int, default=3000)
    ap.add_argument("--n-envs", type=int, default=8, help="parallel actors")
    ap.add_argument("--fanout", type=int, default=128, help="sum-tree K")
    ap.add_argument("--backend", choices=("cuda", "torch"), default=None,
                    help="TreeOps backend (default: cuda on a GPU, torch on "
                         "the CPU)")
    ap.add_argument("--update-interval", type=int, default=1,
                    help="env steps per learn (paper ratio)")
    ap.add_argument("--eager-replay", action="store_true",
                    help="per-op tree propagation instead of the lazy "
                         "one-pass-per-iteration transaction")
    ap.add_argument("--fused-sample-gather", action="store_true",
                    help="descend and fetch storage rows in one kernel")
    ap.add_argument("--executor", choices=("sync", "async"), default="sync",
                    help="async = actors act on a delayed parameter copy "
                         "(AsyncExecutor)")
    ap.add_argument("--publish-interval", type=int, default=4,
                    help="iterations between actor-copy republishes "
                         "(async executor; 1 = synchronous semantics)")
    ap.add_argument("--shards", type=int, default=0,
                    help="run the ShardedExecutor over this many shards, one "
                         "process each (0 = fused); with --pods this is the "
                         "per-pod data-axis extent")
    ap.add_argument("--pods", type=int, default=0,
                    help="add a pod axis: a (pods × shards) two-axis mesh")
    ap.add_argument("--compress-pod-reduce", action="store_true",
                    help="int8 error-feedback compressed gradient reduce "
                         "across the pod axis (needs --pods)")
    ap.add_argument("--bf16-intra-pod", action="store_true",
                    help="cast the intra-pod (fast-axis) gradient reduce "
                         "to bf16 on the wire (needs --shards); the "
                         "injected error is the compress_error_norm "
                         "metric")
    ap.add_argument("--max-staleness", type=int, default=1,
                    help="drop a shard from the gradient reduce once its "
                         "acting copy ages past this many iterations "
                         "(sharded async executor)")
    ap.add_argument("--backend-dist", choices=meshlib.BACKENDS, default="gloo",
                    help="torch.distributed backend of the shards: gloo runs "
                         "several ranks on one card, nccl needs a card per rank")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.plan:
        plan = load_plan(args.plan)
        print(f"plan: {plan.describe()}", flush=True)
        if args.bf16_intra_pod and not plan.n_data:
            ap.error("--bf16-intra-pod needs a plan with a mesh (the fused path has no "
                     "cross-shard reduce to cast)")
        resolve_device(args.device)           # no GPU and no --device cpu: raise here
        if not plan.n_data:
            return _planned(0, args, plan)
        if args.backend_dist == "nccl" and plan.n_devices > 1:
            ap.error(f"--backend-dist nccl needs a card per rank: a plan of "
                     f"{plan.n_devices} ranks on one device needs --backend-dist gloo")
        return meshlib.spawn(_planned, plan.n_devices, args, plan,
                             backend=args.backend_dist, device=args.device,
                             timeout_s=24 * 3600.0)[0]
    if args.pods and not args.shards:
        args.shards = 1                       # pods alone: a P×1 mesh
    if args.compress_pod_reduce and not args.pods:
        ap.error("--compress-pod-reduce needs --pods (the compressed leg "
                 "crosses the pod axis)")
    if args.bf16_intra_pod and not args.shards:
        ap.error("--bf16-intra-pod needs --shards (the fused path has no "
                 "cross-shard reduce to cast)")
    if args.shards:
        world = args.shards * max(1, args.pods)
        if args.backend_dist == "nccl" and world > 1:
            ap.error(f"--backend-dist nccl needs a card per rank: {world} shards on "
                     "one device need --backend-dist gloo")
        resolve_device(args.device)           # no GPU and no --device cpu: raise here
        return meshlib.spawn(_sharded_rank, world, args, backend=args.backend_dist,
                             device=args.device, timeout_s=24 * 3600.0)[0]

    env_fn, spec, agent, cfg = _setup(args)
    replay = PrioritizedReplay(
        ReplayConfig(capacity=50_000, fanout=args.fanout, backend=args.backend,
                     fused_sample_gather=args.fused_sample_gather),
        transition_example(spec), device=args.device)
    if args.executor == "async":
        ex = AsyncExecutor(agent, replay, env_fn, cfg, args.n_envs,
                           publish_interval=args.publish_interval, device=args.device)
        print(f"async executor on {ex.device}: actors on a copy republished every "
              f"{args.publish_interval} iterations, tree backend {replay.ops.name}")
    else:
        ex = FusedExecutor(agent, replay, env_fn, cfg, args.n_envs,
                           device=args.device)
        print(f"fused executor on {ex.device}, tree backend {replay.ops.name}")
    return _train(ex, args, log=True)


if __name__ == "__main__":
    main()
