"""Token-DQN training entry point — port of ``repro.launch.train``:
parallel actors on the token MDP, prioritized replay on the port's
kernels, and the token-Q learner, with checkpoint and restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2_1_8b \\
        --attn-impl flash --seq 256 --steps 6 --ckpt-every 3
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --seq 128 --attn-impl flash --steps 4 --ckpt-every 2
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 6 --n-envs 8 \\
        --wall-clock 2

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

``--wall-clock N`` re-launches this entry point as N worker processes
(``launch/multiprocess.py::run_gang``), each a rank of a gloo process
group joined through ``core.distributed.initialize_distributed`` (ranks
share the card, which NCCL refuses).  Workers split ``--n-envs`` evenly,
run the same training on their own actor streams (their resets differ)
and average the parameters over the gang after every train step: a real
device→host→gloo→device round trip.  Worker 0 prints the steps and writes
the checkpoints; every worker prints ``arch=`` and, at the end, its
parameter checksum and flash launches.  It cannot be combined with
``--plan`` or ``--mesh``.

``--plan BENCH_plan.json`` applies a ``runtime/planner.py`` plan: its
``n_envs`` replaces ``--n-envs`` and the run prints the plan and
``mesh=plan:PxD``.  The reference installs the planned (pod×)data mesh
only as the ambient mesh of an unsharded model (``NO_SHARDING``), which
changes no computation; so the port runs the same single-process
training and spawns no ranks.  The executor-level form of a plan is
``runtime/executors.py::executor_from_plan`` (``python -m
repro_torch.quickstart --plan``).

``--mesh 16x16`` (or ``2x16x16``) runs as the reference's does: one
process, ``shd = launch.mesh.sharding_config(...)`` passed to the collect
and the learner, and a production mesh that only describes its shape and
is never installed.  No tensor is a DTensor, so every sharding constraint
leaves its tensor as it is and the run computes what ``--mesh host``
computes, bit for bit, with one exception, the reference's too: with
``cfg.moe_local_dispatch`` a moe layer splits its routing and capacity
into ``dp_extent`` shards whenever that divides its tokens
(``models/moe.py``).  The model sharded over ranks is
``launch/sharded.py``.

Differences from the reference: each random draw of the collect (the
random action, the ε decision, the environment's next token) comes from
its own generator stream, where the reference draws all three from one
key; it prints every step, where the reference prints every tenth.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.agents import token_dqn
from repro_torch.agents.base import state_tensors
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig, ReplayState
from repro_torch.device import resolve_device
from repro_torch.envs import token_mdp
from repro_torch.models import backbone
from repro_torch.models.config import NO_SHARDING, ModelConfig, ShardingConfig
from repro_torch.optim import adam
from repro_torch.runtime.loop import shard_seed

EPSILON = 0.1          # the actors' exploration rate
CONTEXT = 8            # tokens of context the actors act on
CAPACITY, FANOUT = 8192, 128
# a wall-clock worker's place in the gang, set by the parent
WC_COORD, WC_NPROCS, WC_PID = "REPRO_WC_COORD", "REPRO_WC_NPROCS", "REPRO_WC_PID"


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
    ap.add_argument("--mesh", default="host", choices=("host", "16x16", "2x16x16"),
                    help="the production mesh whose sharding config the model takes "
                         "(one process, as the reference's run)")
    ap.add_argument("--plan", default=None, metavar="BENCH_plan.json",
                    help="apply a runtime.planner plan: its n_envs replaces --n-envs; "
                         "the planned mesh only wraps the unsharded model in the "
                         "reference, so the run stays one process (--mesh must stay "
                         "'host')")
    ap.add_argument("--wall-clock", type=int, default=0, metavar="N",
                    help="launch N worker processes, ranks of a gloo process group, "
                         "instead of the in-process run; the parameters are averaged "
                         "over the gang after every step")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--attn-impl", choices=("naive", "flash", "chunked_q"), default=None,
                    help="ModelConfig.attn_impl (default: the config's own); flash "
                         "runs on segment lengths that are multiples of 128")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.wall_clock > 1 and (args.plan or args.mesh != "host"):
        ap.error("--wall-clock spawns real processes — drop --plan/--mesh (those "
                 "describe a topology inside one process)")
    if args.plan and args.mesh != "host":
        ap.error("--plan carries its own mesh — drop --mesh")
    return args


@torch.no_grad()
def collect(cfg: ModelConfig, params: backbone.Backbone, step_env, env_state, obs,
            seq: int, gens: Dict[str, torch.Generator],
            shd: ShardingConfig = NO_SHARDING):
    """One segment of ``seq`` steps from every actor → (env state, last
    tokens, {"tokens", "actions", "rewards", "dones"} each (n_envs, seq))."""
    ctx = obs[:, None].repeat(1, CONTEXT)
    cols = {"tokens": [], "actions": [], "rewards": [], "dones": []}
    for _ in range(seq):
        greedy = torch.argmax(backbone.forward(cfg, params, ctx, shd=shd)[:, -1], dim=-1)
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


# the named generator streams of a token run; stream i is seeded seed * 8 + i
GEN_NAMES = ("init", "table", "reset", "action", "epsilon", "env", "sample")


@dataclasses.dataclass
class TokenSetup:
    """What a token-DQN run builds before its loop (``token_setup``)."""
    gens: Dict[str, torch.Generator]
    state: token_dqn.TrainState
    step_env: Callable
    optimal: Callable[[], float]
    env_state: token_mdp.TokenMDPState
    obs: torch.Tensor
    replay: PrioritizedReplay
    replay_state: ReplayState
    mgr: CheckpointManager
    start: Optional[int]


def token_setup(cfg: ModelConfig, tcfg: token_dqn.TokenDQNConfig, replay_config: ReplayConfig,
                *, n_envs: int, seq: int, seed: int, device: torch.device, ckpt_dir: str,
                reset_seed: Optional[int] = None) -> TokenSetup:
    """The set-up both token trainers share (this entry point and
    ``train_token_dqn``): the generator streams, a fresh train state, the
    token MDP's ``n_envs`` actors and their first tokens, an empty replay of
    ``seq``-token segments, and the newest checkpoint restored into the
    state (``start`` is its step, or None).  ``reset_seed`` replaces the
    reset stream's seed (a wall-clock worker's own).  The device's peak
    memory counter is reset last, so ``peak_memory`` reads the run's."""
    seeds = {name: seed * 8 + i for i, name in enumerate(GEN_NAMES)}
    if reset_seed is not None:
        seeds["reset"] = reset_seed
    gens = {name: torch.Generator(device=device).manual_seed(s) for name, s in seeds.items()}
    state = token_dqn.init_train_state(cfg, tcfg, gens["init"])
    reset, step_env, optimal = token_mdp.make(token_mdp.TokenMDPSpec(vocab=cfg.vocab_size),
                                              gens["table"], n_envs)
    env_state, obs = reset(gens["reset"])
    example = {"tokens": torch.zeros((seq,), dtype=torch.int32),
               "actions": torch.zeros((seq,), dtype=torch.int32),
               "rewards": torch.zeros((seq,), dtype=torch.float32),
               "dones": torch.zeros((seq,), dtype=torch.float32)}
    replay = PrioritizedReplay(replay_config, example, device=device)
    rst = replay.init()
    mgr = CheckpointManager(ckpt_dir, keep=2)
    start, _ = mgr.restore_latest(state_tensors(state))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return TokenSetup(gens, state, step_env, optimal, env_state, obs, replay, rst, mgr, start)


def peak_memory(device: torch.device) -> Optional[int]:
    """The device's peak allocated bytes since ``token_setup``; None on the CPU."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_param_averager(world: int):
    """The wall-clock gang's parameter mean: every parameter of the module
    goes device → host as one f32 vector, gloo sums it over the process
    group, and the mean is copied back into the module's own tensors (cast
    to their dtype) — a real device→host→gloo→device round trip."""
    import torch.distributed as dist

    @torch.no_grad()
    def sync(module: torch.nn.Module) -> None:
        params = list(module.parameters())
        # repro-lint: disable=R404(the gang's parameter mean goes through the host by design, one f32 vector over gloo; ROADMAP item 37 keeps it on the device)
        host = torch.cat([p.detach().reshape(-1).to("cpu", torch.float32) for p in params])
        dist.all_reduce(host)
        host /= world
        for p, part in zip(params, torch.split(host, [p.numel() for p in params])):
            p.copy_(part.view(p.shape))

    return sync


def params_sum(module: torch.nn.Module) -> float:
    """Σ of every parameter element, in f64: linear, so the average's sum
    is the mean of the workers' sums up to rounding."""
    return float(sum(p.detach().double().sum().item() for p in module.parameters()))


def run(args: argparse.Namespace) -> dict:
    """The training loop → {"state", "history", "start", ...} for callers
    that check it (the tests, ``chip_smoke.py``).  In a wall-clock worker
    (``REPRO_WC_*`` set by the parent) it first joins the gang."""
    device = resolve_device(args.device)
    wc_world, wc_pid, sync_params = 1, 0, None
    if os.environ.get(WC_COORD) is not None:
        from repro_torch.core.distributed import initialize_distributed

        wc_world, wc_pid = int(os.environ[WC_NPROCS]), int(os.environ[WC_PID])
        initialize_distributed(os.environ[WC_COORD], wc_world, wc_pid, backend="gloo")
        if args.n_envs % wc_world:
            raise ValueError(f"--n-envs {args.n_envs} not divisible by the "
                             f"{wc_world}-process gang")
        args.n_envs //= wc_world
        if wc_world > 1:
            sync_params = make_param_averager(wc_world)
    lead = wc_pid == 0
    plan = None
    if args.plan:
        from repro_torch.runtime.planner import load_plan

        plan = load_plan(args.plan)
        args.n_envs = plan.n_envs
        print(f"plan: {plan.describe()}", flush=True)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    tcfg = token_config()
    mesh, shd = None, NO_SHARDING
    if args.mesh != "host":
        from repro_torch.launch.mesh import make_production_mesh, sharding_config

        # the reference's one-process run: the mesh describes the shape and
        # is never installed; the model takes its sharding config
        mesh = make_production_mesh(multi_pod=args.mesh == "2x16x16")
        shd = sharding_config(args.mesh == "2x16x16")
    # the workers of a gang share everything but their envs' resets
    setup = token_setup(cfg, tcfg, ReplayConfig(capacity=CAPACITY, fanout=FANOUT),
                        n_envs=args.n_envs, seq=args.seq, seed=args.seed, device=device,
                        ckpt_dir=args.ckpt_dir,
                        reset_seed=shard_seed(args.seed * 8 + GEN_NAMES.index("reset"), wc_pid))
    gens, state, step_env, optimal = setup.gens, setup.state, setup.step_env, setup.optimal
    env_state, obs, replay, rst = setup.env_state, setup.obs, setup.replay, setup.replay_state
    mgr, start = setup.mgr, setup.start
    n_params = sum(p.numel() for p in state.params.parameters())
    mesh_desc = f"plan:{plan.n_pods}x{plan.n_data}" if plan is not None else args.mesh
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M dtype={cfg.dtype} "
          f"attn_impl={cfg.attn_impl} device={device} mesh={mesh_desc}", flush=True)
    if start is not None:
        print(f"resumed from step {start} (fault-tolerant restart)", flush=True)

    history = []
    t_run = time.perf_counter()
    for it in range(int(state.step), args.steps):
        t0 = time.perf_counter()
        env_state, obs, seg = collect(cfg, state.params, step_env, env_state, obs, args.seq,
                                      gens, shd)
        _sync(device)
        t1 = time.perf_counter()
        rst = replay.flush(replay.append(rst, seg, lazy=True))
        idx, items, w = replay.sample(rst, gens["sample"], args.batch)
        state, metrics, tds = token_dqn.train_step(cfg, shd, tcfg, state, dict(items, is_weights=w))
        rst = replay.update_priorities(rst, idx, tds, lazy=True)
        if sync_params is not None:
            pre_average = params_sum(state.params)
            sync_params(state.params)
        _sync(device)
        t2 = time.perf_counter()
        rec = {"step": it, "collect_s": t1 - t0, "train_s": t2 - t1,
               **{k: float(v) for k, v in metrics.items()},
               "reward": float(seg["rewards"].mean())}
        history.append(rec)
        if lead:
            print(f"step {it:4d} collect {rec['collect_s']:.2f} s train {rec['train_s']:.3f} s "
                  f"loss {rec['loss']:.4f} grad_norm {rec['grad_norm']:.4f} q_mean "
                  f"{rec['q_mean']:.4f} reward {rec['reward']:.3f} (optimal "
                  f"{optimal():.3f})", flush=True)
        if args.ckpt_every and it and it % args.ckpt_every == 0 and lead:
            mgr.save_async(it, state_tensors(state))
    mgr.wait()
    if lead:
        mgr.save(args.steps, state_tensors(state))
    # the last step's priorities reach the interior at this flush
    root_before = float(rst.tree[0])
    rst = replay.flush(rst)
    root_after = float(rst.tree[0])
    peak = peak_memory(device)
    secs = time.perf_counter() - t_run
    if lead:
        print(f"trained {args.steps - (start or 0)} steps in {secs:.1f} s; peak device "
              "memory " + (f"{peak / 2**30:.2f} GiB" if peak is not None
                           else "not measured (CPU)"), flush=True)
    if wc_world > 1:
        import torch.distributed as dist

        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ops
        from repro_torch.launch import multiprocess as mp

        # the gang's result lines (KEY=VALUE), read by tests and chip_smoke.py
        print(f"WORKER={wc_pid}")
        if history:
            print(f"PRE_AVERAGE_SUM={pre_average!r}")
        print(f"PARAMS_SUM={params_sum(state.params)!r}")
        print(f"PARAMS_CHECKSUM={mp.params_checksum(state.params)!r}")
        print(f"STEPS={len(history)}")
        for name in (fa.NAME, fa.DQ_NAME, fa.DKV_NAME, fa.SM90_NAME, fa.DQ_SM90_NAME,
                     fa.DKV_SM90_NAME):
            print(f"LAUNCH_{name.upper()}={ops.launch_counts.get(name, 0)}", flush=True)
        dist.destroy_process_group()
    return {"cfg": cfg, "tcfg": tcfg, "state": state, "history": history, "start": start,
            "replay": replay, "replay_state": rst, "root_before_flush": root_before,
            "root_after_flush": root_after, "optimal_reward": optimal(),
            "peak_memory_bytes": peak, "seconds": secs, "plan": plan, "mesh": mesh,
            "shd": shd}


def launch_wall_clock(args: argparse.Namespace, argv) -> dict:
    """The parent of ``--wall-clock N``: re-run this entry point as N workers
    (``REPRO_WC_*`` in their environment), print each worker's output
    prefixed with ``[worker i]`` and return ``{"workers": [output, ...]}``.
    A failing worker ends the gang and raises (``run_gang``)."""
    from repro_torch.launch import multiprocess as mp

    resolve_device(args.device)      # no GPU and no --device cpu: raise before spawning
    n = args.wall_clock
    argv = list(sys.argv[1:] if argv is None else argv)
    keep, skip = [], False
    for a in argv:
        if not skip and a != "--wall-clock" and not a.startswith("--wall-clock="):
            keep.append(a)
        skip = a == "--wall-clock"
    env = mp.worker_env(n)
    env[WC_COORD] = f"127.0.0.1:{mp.free_port()}"
    env[WC_NPROCS] = str(n)
    cmds = [[sys.executable, "-m", "repro_torch.launch.train", *keep] for _ in range(n)]
    envs = [dict(env, **{WC_PID: str(pid)}) for pid in range(n)]
    outs = mp.run_gang(cmds, envs, timeout_s=24 * 3600.0)
    for pid, out in enumerate(outs):
        for line in out.splitlines():
            print(f"[worker {pid}] {line}")
    return {"workers": outs}


def main(argv=None) -> Optional[dict]:
    args = parse_args(argv)
    if args.wall_clock > 1 and os.environ.get(WC_COORD) is None:
        return launch_wall_clock(args, argv)
    return run(args)


if __name__ == "__main__":
    main()
    sys.exit(0)
