"""End-to-end token-DQN trainer — port of ``examples/train_token_dqn.py``:
an LM-backbone token-Q learner (the reference's "~100M" config: 39.9 M
parameters) trained on the token MDP with the paper's whole pipeline —
parallel actors collecting trajectory segments into the prioritized
replay, the learner sampling with PER weights, priorities written back
from the TD errors, a checkpoint every ``--ckpt-every`` collects and a
resume from the newest one.

The collect/learn interleave is the executors' ``RatioSchedule``
(``runtime/loop.py``): ``--update-interval`` collected segments per
learner update, ``--learns-per-step`` updates per learn event.  The
replay's tree ops run on the port's kernels on the card (``--backend
cuda``, the replay's default there) or on their plain PyTorch versions
(``--backend torch``), the reference's ``pallas`` and ``xla``.

    PYTHONPATH=src python -m repro_torch.train_token_dqn --steps 300
    PYTHONPATH=src python -m repro_torch.train_token_dqn --small --device cpu --steps 40

Each collect takes one segment of ``--seq`` tokens from each of
``--n-envs`` actors (ε = 0.1 over the greedy Q action of an 8-token
context, ``launch/train.py::collect``) and inserts it; inserts and
priority updates are eager, as the reference's, so on the card they
launch the update kernel besides the sample and gather kernels.
Checkpoints are labelled by collect iteration, which with a ratio
schedule is not the learner's step count.

Differences from the reference: the random action, the ε decision and
the environment's next token come from their own ``torch.Generator``
streams, where the reference draws all three from one key (ROADMAP
Queue 3 item 5); ``main`` returns what it did (the learn events, the
schedule, the start and the peak device memory) for tests and
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch

from repro_torch.agents import token_dqn
from repro_torch.agents.base import state_tensors
from repro_torch.core.replay import ReplayConfig
from repro_torch.device import resolve_device
from repro_torch.launch.train import collect, peak_memory, token_config, token_setup
from repro_torch.models.config import NO_SHARDING, ModelConfig
from repro_torch.runtime.loop import LoopConfig, RatioSchedule

# the reference's "~100M" config: 8L × d512 × vocab 8192 GQA, 39.9 M params
CFG_100M = ModelConfig(
    name="token-dqn-100m", family="dense", num_layers=8, d_model=512,
    num_heads=8, num_kv_heads=4, d_ff=2048, vocab_size=8192,
    dtype="float32", remat=False,
)
CAPACITY, FANOUT = 4096, 128
PRINT_EVERY = 20


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=64, help="segment length")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-envs", type=int, default=32)
    ap.add_argument("--small", action="store_true", help="tiny debug model")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_token_dqn_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--update-interval", type=int, default=32,
                    help="collected segments per learner update")
    ap.add_argument("--learns-per-step", type=int, default=1)
    ap.add_argument("--backend", choices=("torch", "cuda"), default=None,
                    help="the replay's tree ops: the kernels (cuda) or their plain "
                         "versions (torch); default the replay's own, cuda on the card")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def model_config(small: bool) -> ModelConfig:
    if small:
        return dataclasses.replace(CFG_100M, num_layers=2, d_model=64, num_heads=4,
                                   num_kv_heads=2, d_ff=128, vocab_size=256)
    return CFG_100M


def schedule_for(args: argparse.Namespace) -> RatioSchedule:
    return RatioSchedule.from_config(
        LoopConfig(update_interval=args.update_interval,
                   learns_per_step=args.learns_per_step),
        env_steps_per_iter=args.n_envs)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_config(args.small)
    tcfg = token_config()
    setup = token_setup(cfg, tcfg, ReplayConfig(capacity=CAPACITY, fanout=FANOUT,
                                                backend=args.backend),
                        n_envs=args.n_envs, seq=args.seq, seed=args.seed, device=device,
                        ckpt_dir=args.ckpt_dir)
    gens, state, step_env, optimal = setup.gens, setup.state, setup.step_env, setup.optimal
    env_state, obs, replay, rst = setup.env_state, setup.obs, setup.replay, setup.replay_state
    mgr, start = setup.mgr, setup.start
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"model: {cfg.name}  params: {n_params / 1e6:.1f}M", flush=True)
    schedule = schedule_for(args)
    print(f"ratio schedule: learn every {schedule.period} collect(s), "
          f"{schedule.learns} update(s) per event "
          f"({schedule.realized_ratio:.0f} segments per update)", flush=True)
    if start is not None:
        print(f"resumed from checkpoint step {start}", flush=True)

    t0 = time.perf_counter()
    learns, rewards = [], []
    loss = float("nan")
    # checkpoints are labelled by collect iteration, which (with a ratio
    # schedule) is no longer equal to state.step (learner-update count)
    for it in range(start or 0, args.steps):
        env_state, obs, seg = collect(cfg, state.params, step_env, env_state, obs,
                                      args.seq, gens)
        rst = replay.insert(rst, seg)
        if it % schedule.period == 0:
            for _ in range(schedule.learns):
                idx, items, w = replay.sample(rst, gens["sample"], args.batch)
                state, metrics, tds = token_dqn.train_step(cfg, NO_SHARDING, tcfg, state,
                                                           dict(items, is_weights=w))
                rst = replay.update_priorities(rst, idx, tds)
                learns.append({"it": it, **{k: float(v) for k, v in metrics.items()}})
            loss = learns[-1]["loss"]
        reward = float(seg["rewards"].mean())
        rewards.append(reward)
        if it % PRINT_EVERY == 0:
            print(f"step {it:4d} loss {loss:.4f} actor-reward {reward:.3f} (optimal "
                  f"{optimal():.3f}) buffer {rst.count}", flush=True)
        if args.ckpt_every and it and it % args.ckpt_every == 0:
            mgr.save_async(it, state_tensors(state))
    mgr.wait()
    mgr.save(args.steps, state_tensors(state))
    secs = time.perf_counter() - t0
    peak = peak_memory(device)
    print(f"done in {secs:.0f}s; checkpoint at {args.ckpt_dir}", flush=True)
    return {"cfg": cfg, "tcfg": tcfg, "state": state, "schedule": schedule, "start": start,
            "learns": learns, "rewards": rewards, "replay": replay, "replay_state": rst,
            "optimal_reward": optimal(), "peak_memory_bytes": peak, "seconds": secs,
            "checkpoints": mgr.all_steps()}


if __name__ == "__main__":
    main()
    sys.exit(0)
