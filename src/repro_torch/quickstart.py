"""Quickstart: the paper end to end on one device — parallel actors,
K-ary sum-tree prioritized replay and DDQN learners on CartPole, through
the fused executor, or the async one (actors on a parameter copy
republished every ``--publish-interval`` iterations).  The port's
counterpart of ``examples/quickstart.py`` in its single-device forms.

    PYTHONPATH=src python -m repro_torch.quickstart [--iterations 3000]
    PYTHONPATH=src python -m repro_torch.quickstart --backend torch     # plain ops
    PYTHONPATH=src python -m repro_torch.quickstart --fused-sample-gather
    PYTHONPATH=src python -m repro_torch.quickstart --eager-replay
    PYTHONPATH=src python -m repro_torch.quickstart --executor async --publish-interval 4
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu --iterations 512
"""

from __future__ import annotations

import argparse
import functools
import time

import torch

from repro_torch.agents.dqn import DQNConfig, make_dqn
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
from repro_torch.envs.classic import make_vec
from repro_torch.runtime.executors import AsyncExecutor, FusedExecutor
from repro_torch.runtime.loop import LoopConfig


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    env_fn = functools.partial(make_vec, "cartpole")
    spec, _, _ = env_fn(1)
    agent = make_dqn(spec, DQNConfig(double_q=True))
    cfg = LoopConfig(batch_size=64, warmup=500, epsilon=0.15,
                     update_interval=args.update_interval,
                     lazy_replay=not args.eager_replay)
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
    print(f"ratio schedule: {ex.schedule} "
          f"(realized {ex.schedule.realized_ratio:.1f} env steps per learn)")
    t0 = time.perf_counter()
    state, hist = ex.train(args.iterations, args.seed, log_every=256)
    secs = time.perf_counter() - t0
    print(f"\n{state.env_steps} env steps, {state.learn_steps} learner calls "
          f"in {secs:.1f} s ({state.env_steps / secs:,.0f} env-steps/s)")
    print("final mean episode return: "
          f"{float(hist['mean_episode_return'][-1]):.1f} "
          "(CartPole solved ≈ 475; random ≈ 10)")
    return state, hist


if __name__ == "__main__":
    main()
