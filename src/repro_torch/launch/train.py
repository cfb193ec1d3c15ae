"""Token-DQN training entry point — port of ``repro.launch.train`` on one
device: parallel actors on the token MDP, prioritized replay on the
port's kernels, and the token-Q learner, with checkpoint and restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \\
        --attn-impl flash --seq 256 --steps 6 --ckpt-every 3
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --seq 128 --attn-impl flash --steps 4 --ckpt-every 2

Each step collects one segment of ``--seq`` tokens from each of
``--n-envs`` actors (ε = 0.1 over the greedy Q action of an 8-token
context), appends it to the replay (capacity 8,192, K = 128), samples
``--batch`` segments, runs ``train_step`` and writes the new priorities
back.  Replay writes are lazy and flushed before each sample, so the
path launches the sample and gather kernels and no update kernel.  With
``--attn-impl flash`` and a segment length that is a multiple of 128 the
learner's attention runs the flash forward, dQ and dK/dV kernels; the
collect's 8-token context never does.  Weights are random, made on the
device from ``--seed``.

Differences from the reference: each random draw of the collect (the
random action, the ε decision, the environment's next token) comes from
its own generator stream, where the reference draws all three from one
key; it prints every step, where the reference prints every tenth.
``--wall-clock``, ``--mesh`` other than ``host`` and
``--plan`` exit 2: they wait for ROADMAP Queue 1 items 22 and 21.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from typing import Dict, Optional

import torch

from repro_torch.agents import token_dqn
from repro_torch.agents.base import state_tensors
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
from repro_torch.device import resolve_device
from repro_torch.envs import token_mdp
from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adam

EPSILON = 0.1          # the actors' exploration rate
CONTEXT = 8            # tokens of context the actors act on
CAPACITY, FANOUT = 8192, 128


def token_config() -> token_dqn.TokenDQNConfig:
    """The learner's settings, the reference's: γ 0.9, no accumulation,
    Adam at lr 1e-4."""
    return token_dqn.TokenDQNConfig(gamma=0.9, accum=1, opt=adam.AdamConfig(lr=1e-4))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite_8b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-envs", type=int, default=16)
    ap.add_argument("--mesh", default="host",
                    help="only 'host' is ported: model sharding over a device mesh is not "
                         "(ROADMAP item 21)")
    ap.add_argument("--plan", default=None, metavar="BENCH_plan.json",
                    help="not ported (ROADMAP item 22)")
    ap.add_argument("--wall-clock", type=int, default=0, metavar="N",
                    help="not ported (ROADMAP item 22)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--attn-impl", choices=("naive", "flash", "chunked_q"), default=None,
                    help="ModelConfig.attn_impl (default: the config's own); flash "
                         "runs on segment lengths that are multiples of 128")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.wall_clock > 1:
        ap.exit(2, "--wall-clock: the multi-process gang is not ported to repro_torch "
                   "yet (ROADMAP Queue 1 item 22)\n")
    if args.mesh != "host":
        ap.exit(2, f"--mesh {args.mesh}: model sharding over a device mesh is not ported "
                   "to repro_torch yet; the data-parallel sharded runtime is "
                   "(runtime/executors.py::ShardedExecutor) (ROADMAP Queue 1 item 21)\n")
    if args.plan:
        ap.exit(2, "--plan: executor_from_plan and the planner are not ported to "
                   "repro_torch yet (ROADMAP Queue 1 item 22)\n")
    return args


@torch.no_grad()
def collect(cfg: ModelConfig, params: backbone.Backbone, step_env, env_state, obs,
            seq: int, gens: Dict[str, torch.Generator]):
    """One segment of ``seq`` steps from every actor → (env state, last
    tokens, {"tokens", "actions", "rewards", "dones"} each (n_envs, seq))."""
    ctx = obs[:, None].repeat(1, CONTEXT)
    cols = {"tokens": [], "actions": [], "rewards": [], "dones": []}
    for _ in range(seq):
        greedy = torch.argmax(backbone.forward(cfg, params, ctx)[:, -1], dim=-1)
        rand = torch.randint(0, cfg.vocab_size, greedy.shape, generator=gens["action"],
                             device=greedy.device)
        explore = torch.rand(greedy.shape, generator=gens["epsilon"],
                             device=greedy.device) < EPSILON
        act = torch.where(explore, rand, greedy)
        env_state, nxt, rew, done = step_env(env_state, act, gens["env"])
        ctx = torch.cat([ctx[:, 1:], nxt[:, None]], dim=1)
        for key, x in zip(cols, (obs, act, rew, done)):
            cols[key].append(x)
        obs = nxt
    seg = {k: torch.stack(v, dim=1) for k, v in cols.items()}
    seg["tokens"], seg["actions"] = seg["tokens"].int(), seg["actions"].int()
    seg["dones"] = seg["dones"].float()
    return env_state, obs, seg


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    """The training loop → {"state", "history", "start", ...} for callers
    that check it (the tests, ``chip_smoke.py``)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    tcfg = token_config()
    gens = {name: torch.Generator(device=device).manual_seed(args.seed * 8 + i)
            for i, name in enumerate(("init", "table", "reset", "action", "epsilon", "env",
                                      "sample"))}
    state = token_dqn.init_train_state(cfg, tcfg, gens["init"])
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M dtype={cfg.dtype} "
          f"attn_impl={cfg.attn_impl} device={device}", flush=True)

    reset, step_env, optimal = token_mdp.make(token_mdp.TokenMDPSpec(vocab=cfg.vocab_size),
                                              gens["table"], args.n_envs)
    env_state, obs = reset(gens["reset"])
    example = {"tokens": torch.zeros((args.seq,), dtype=torch.int32),
               "actions": torch.zeros((args.seq,), dtype=torch.int32),
               "rewards": torch.zeros((args.seq,), dtype=torch.float32),
               "dones": torch.zeros((args.seq,), dtype=torch.float32)}
    replay = PrioritizedReplay(ReplayConfig(capacity=CAPACITY, fanout=FANOUT), example,
                               device=device)
    rst = replay.init()

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start, _ = mgr.restore_latest(state_tensors(state))
    if start is not None:
        print(f"resumed from step {start} (fault-tolerant restart)", flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    history = []
    t_run = time.perf_counter()
    for it in range(int(state.step), args.steps):
        t0 = time.perf_counter()
        env_state, obs, seg = collect(cfg, state.params, step_env, env_state, obs, args.seq,
                                      gens)
        _sync(device)
        t1 = time.perf_counter()
        rst = replay.flush(replay.append(rst, seg, lazy=True))
        idx, items, w = replay.sample(rst, gens["sample"], args.batch)
        state, metrics, tds = token_dqn.train_step(cfg, tcfg, state, dict(items, is_weights=w))
        rst = replay.update_priorities(rst, idx, tds, lazy=True)
        _sync(device)
        t2 = time.perf_counter()
        rec = {"step": it, "collect_s": t1 - t0, "train_s": t2 - t1,
               **{k: float(v) for k, v in metrics.items()},
               "reward": float(seg["rewards"].mean())}
        history.append(rec)
        print(f"step {it:4d} collect {rec['collect_s']:.2f} s train {rec['train_s']:.3f} s "
                  f"loss {rec['loss']:.4f} grad_norm {rec['grad_norm']:.4f} q_mean "
              f"{rec['q_mean']:.4f} reward {rec['reward']:.3f} (optimal "
              f"{optimal():.3f})", flush=True)
        if args.ckpt_every and it and it % args.ckpt_every == 0:
            mgr.save_async(it, state_tensors(state))
    mgr.wait()
    mgr.save(args.steps, state_tensors(state))
    # the last step's priorities reach the interior at this flush
    root_before = float(rst.tree[0])
    rst = replay.flush(rst)
    root_after = float(rst.tree[0])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    secs = time.perf_counter() - t_run
    print(f"trained {args.steps - (start or 0)} steps in {secs:.1f} s; peak device memory "
          + (f"{peak / 2**30:.2f} GiB" if peak is not None else "not measured (CPU)"),
          flush=True)
    return {"cfg": cfg, "tcfg": tcfg, "state": state, "history": history, "start": start,
            "replay": replay, "replay_state": rst, "root_before_flush": root_before,
            "root_after_flush": root_after, "optimal_reward": optimal(),
            "peak_memory_bytes": peak, "seconds": secs}


def main(argv=None) -> Optional[dict]:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
