"""The wall-clock multi-process gang and the replay-service gang — port
of ``repro.launch.multiprocess`` (DESIGN.md §10, §11, §14).

**The wall-clock gang** (``launch``, ``--mode bench|fused|equiv``): N
worker processes, each one rank of a ``torch.distributed`` process group
joined by ``core.distributed.initialize_distributed`` (rank 0 hosts the
rendezvous at ``--coordinator``; ranks that share one card take gloo,
NCCL wants a card a rank).  After the handshake ``launch/mesh.py``'s
meshes span the gang, so the sharded executors run unchanged and the
gradient reduce crosses real process boundaries.  ``launch`` spawns
``python -m repro_torch.launch.multiprocess`` once per rank, collects
each rank's stdout and, when one rank fails, kills the whole gang and
raises with that rank's output tail.  The workloads:

  * ``--mode bench`` — DQN/CartPole through ``FusedExecutor`` (1 cell) or
    ``ShardedExecutor`` (a data or pod×data mesh over the gang),
    timed median-of-``--repeats`` with ``REL_SPREAD``; each chunk runs
    under ``torch.profiler.record_function("wallclock_chunk")``.  With
    ``--publish-interval P > 0`` the async acting copy is republished
    *externally*: between chunks the fresh params make a real
    device→host→device round trip (``_publish_host_roundtrip``).
  * ``--mode fused`` — the degenerate single-process launch: the exact
    ``FusedExecutor.train`` program, printing final metrics and a
    parameter checksum, bit for bit those of the same executor run in
    process (the process group at N=1 must change nothing).
  * ``--mode equiv`` — the overlapped and the barrier cross-pod reduces
    (``runtime/learner.py::make_grad_reducer``) over a real 2-process
    ``("pod",)`` group: the shift identity and the telescoping error.

Every rank also prints its replay kernels' launches (``LAUNCH_<KERNEL>``)
and learner calls.

**The replay-service gang** (``launch_service``): one ``--mode
replay-server`` process hosting the sharded rate-limited
``ReplayService``, N ``--mode service-actor`` writer processes and one
``--mode service-learner`` sampler process.  The roles share no process
group: each owns its own torch runtime and they meet only at the
service's TCP boundary (append / sample / priority write-back / params
channel), so an actor crash can never wedge a collective.  On the card
the server's shards run the replay kernels, which it builds before it
serves, and it prints their launches.  The server reports the rate
limiter's realized samples-per-insert ratio and its tolerance band.
With ``restart_learner_after`` the learner exits mid-run after
checkpointing and a fresh learner process resumes from the checkpoint
against the still-live service — actors park in writer backpressure for
the gap (the rate limiter, not a barrier, holds the fleet).  With
``restart_server_after`` a hard ``FaultPlan`` kills the server
(``os._exit(42)``) and a fresh one restores its snapshot onto the same
port.

Results travel as ``KEY=VALUE`` lines on stdout (``parse_kv``).  Every
process runs on the card unless given ``--device cpu``
(``launch(..., device="cpu")``, ``launch_service(..., device="cpu")``),
and gets ``cpu_count // n_procs`` intra-op threads (``worker_env`` sets
``OMP_NUM_THREADS``; each process calls ``torch.set_num_threads``):
processes that each take every core spin against each other.

    PYTHONPATH=src python -c "from repro_torch.launch import multiprocess as mp; \\
        print(mp.launch(['--mode', 'equiv'], n_procs=2, device='cpu')[0])"
    PYTHONPATH=src python -c "from repro_torch.launch.multiprocess import launch_service; \\
        print(launch_service(n_actors=2, samples_per_insert=8.0, learn_steps=1400, \\
                             warmup=400, epsilon=0.2, seed=1, device='cpu')['learner'])"
"""

from __future__ import annotations

import argparse
import functools
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

GANG_MODES = ("bench", "fused", "equiv")
SERVICE_ROLES = ("replay-server", "service-actor", "service-learner")
HANDSHAKE_TIMEOUT_S = 60.0
REPLAY_KERNELS = ("sumtree_sample", "gather", "sample_gather", "sumtree_update")


# -- parent side -------------------------------------------------------------


def free_port() -> int:
    """A port the coordinator or the server can bind (raced, but
    single-host tests re-launch on collision rather than coordinate)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _src_root() -> str:
    # .../src/repro_torch/launch/multiprocess.py → .../src
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def worker_env(n_procs: int) -> Dict[str, str]:
    """Child env: ``cpu_count // n_procs`` intra-op threads a process and
    an import path that reaches ``repro_torch`` from any cwd."""
    env = os.environ.copy()
    threads = str(max(1, (os.cpu_count() or 1) // max(1, n_procs)))
    env["OMP_NUM_THREADS"] = threads
    env["MKL_NUM_THREADS"] = threads
    path = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = _src_root() + (os.pathsep + path if path else "")
    return env


def parse_kv(text: str) -> Dict[str, str]:
    """The ``KEY=VALUE`` result lines a worker prints (keys are
    UPPER_SNAKE by convention; later lines win)."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if "=" in line and line.split("=", 1)[0].replace("_", "").isupper():
            k, v = line.split("=", 1)
            out[k] = v
    return out


def _tail(text: str, n: int = 25) -> str:
    return "\n".join(text.splitlines()[-n:])


def run_gang(cmds: Sequence[Sequence[str]], envs: Sequence[Dict[str, str]],
             timeout_s: float = 900.0) -> List[str]:
    """Start one process per command (rank = index), each with its
    environment, and wait for all; return each one's output (stdout and
    stderr).  As soon as one exits non-zero, or the gang overruns
    ``timeout_s``, kill the rest (they would wait on it at their next
    collective) and raise ``RuntimeError`` naming that rank, with its
    output tail."""
    n = len(cmds)
    with tempfile.TemporaryDirectory(prefix="repro_torch_gang_") as tmp:
        procs, logs = [], []
        for pid, (cmd, env) in enumerate(zip(cmds, envs)):
            # a file, not a pipe: a rank that prints more than a pipe holds
            # must not block while the parent waits on another rank
            logs.append(open(os.path.join(tmp, f"rank{pid}.log"), "w+"))
            procs.append(subprocess.Popen(list(cmd), env=env, stdout=logs[-1],
                                          stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while failed is None:
                codes = [p.poll() for p in procs]       # every rank, each round
                failed = next(((pid, f"exit code {c}") for pid, c in enumerate(codes)
                               if c not in (0, None)), None)
                if failed is None and None not in codes:
                    break
                if failed is None and time.monotonic() > deadline:
                    failed = (codes.index(None), "timeout")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    if failed is not None:
        pid, why = failed
        raise RuntimeError(f"wall-clock worker {pid}/{n} failed ({why}); output "
                           f"tail:\n{_tail(outs[pid])}")
    return outs


def launch(
    worker_args: Sequence[str],
    n_procs: int,
    coordinator: Optional[str] = None,
    timeout_s: float = 900.0,
    handshake_timeout_s: float = HANDSHAKE_TIMEOUT_S,
    backend: str = "gloo",
    device: str = "cuda",
) -> List[str]:
    """Spawn the full ``n_procs`` gang of ``python -m
    repro_torch.launch.multiprocess`` ranks and return each rank's stdout
    (index = rank), through ``run_gang``.  Every rank gets ``--backend``
    and ``--device``; ranks that share one card need gloo."""
    from repro_torch.device import resolve_device

    if n_procs < 1:
        raise ValueError(f"n_procs={n_procs}: need ≥ 1")
    resolve_device(device)      # no GPU and no device="cpu": raise before spawning
    coordinator = coordinator or f"127.0.0.1:{free_port()}"
    cmds = [[sys.executable, "-m", "repro_torch.launch.multiprocess",
             "--coordinator", coordinator, "--n-procs", str(n_procs),
             "--process-id", str(pid), "--handshake-timeout", str(handshake_timeout_s),
             "--backend", backend, "--device", device, *worker_args]
            for pid in range(n_procs)]
    return run_gang(cmds, [worker_env(n_procs)] * n_procs, timeout_s)


def _wait_for_server(port: int, proc: subprocess.Popen,
                     timeout_s: float = 90.0) -> None:
    """Poll the service port until it accepts; fail fast (with the
    server's output tail) if the server process dies during startup."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            out, _ = proc.communicate()
            raise RuntimeError(
                f"replay server exited during startup (code "
                f"{proc.returncode}); output tail:\n{_tail(out)}")
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1.0):
                return
        except OSError:
            time.sleep(0.1)
    proc.kill()
    raise RuntimeError(
        f"replay server did not open port {port} within {timeout_s:.0f}s")


def launch_service(
    n_actors: int = 2,
    *,
    n_shards: int = 1,
    samples_per_insert: float = 16.0,
    batch_size: int = 64,
    warmup: int = 512,
    learn_steps: int = 1200,
    n_envs: int = 8,
    actor_chunk: int = 8,
    capacity_per_shard: int = 20_000,
    publish_every: int = 16,
    epsilon: float = 0.2,
    seed: int = 0,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 0,
    restart_learner_after: Optional[int] = None,
    restart_server_after: Optional[int] = None,
    snapshot_dir: Optional[str] = None,
    snapshot_every_appends: int = 0,
    retry_deadline: float = 180.0,
    timeout_s: float = 900.0,
    device: str = "cuda",
    fused_sample_gather: bool = False,
    router: str = "hash",
) -> Dict[str, Dict[str, str]]:
    """Spawn the replay-service gang: 1 server + ``n_actors`` writers +
    1 learner, every role its own process, meeting only at the service's
    TCP boundary.  Returns the parsed ``KEY=VALUE`` results per role
    (``server``, ``actor-<i>``, ``learner``, plus ``learner-0`` for the
    pre-restart learner when ``restart_learner_after`` is set, and
    ``server-0`` for the crashed server when ``restart_server_after`` is
    set).

    With ``restart_learner_after`` the first learner process checkpoints
    and exits after that many learn steps *without* stopping the service
    — actors park in writer backpressure — and a second learner process
    resumes from the checkpoint (``--resume``) and trains to completion.

    With ``restart_server_after`` the *server* is the casualty
    (DESIGN.md §14): a hard FaultPlan kills it with os._exit(42) when
    its Nth append arrives, while ``snapshot_every_appends=1`` has been
    giving durable acks all along.  Clients park in reconnect backoff,
    a fresh server process restores the latest snapshot onto the same
    port, and training runs through to criterion — with the per-writer
    applied counters equal to the clients' acked counts.

    ``device`` is every role's (``"cpu"`` runs the gang without a GPU);
    ``fused_sample_gather`` and ``router`` configure the server's shards
    (the hash router puts ``actor-0``…``actor-3`` all on shard 0 of 2, so
    a multi-shard gang of few actors wants ``"round_robin"``)."""
    from repro_torch.device import resolve_device
    from repro_torch.service.faults import CRASH_EXIT_CODE

    if n_actors < 1:
        raise ValueError(f"n_actors={n_actors}: need ≥ 1")
    if restart_learner_after is not None and not (ckpt_dir and ckpt_every):
        raise ValueError("restart_learner_after requires ckpt_dir and "
                         "ckpt_every (the resumed learner restores from "
                         "the checkpoint directory)")
    if restart_server_after is not None and not (
            snapshot_dir and snapshot_every_appends):
        raise ValueError("restart_server_after requires snapshot_dir and "
                         "snapshot_every_appends (the restarted server "
                         "restores from the shard snapshots)")
    resolve_device(device)      # no GPU and no device="cpu": raise before spawning
    env = worker_env(n_actors + 2)
    port = free_port()
    deadline = time.monotonic() + timeout_s

    def spawn(role_args: List[str]) -> subprocess.Popen:
        cmd = [sys.executable, "-m", "repro_torch.launch.multiprocess", *role_args]
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    common = ["--serve-port", str(port), "--batch-size", str(batch_size),
              "--seed", str(seed), "--device", device,
              "--retry-deadline", str(retry_deadline)]
    # the admission window must absorb one full gang burst: every actor
    # can land a whole rollout chunk between two learner samples
    burst = n_actors * actor_chunk * n_envs
    server_args = ["--mode", "replay-server", *common,
                   "--n-shards", str(n_shards),
                   "--spi", str(samples_per_insert),
                   "--warmup", str(warmup),
                   "--capacity-per-shard", str(capacity_per_shard),
                   "--insert-burst", str(burst),
                   "--router", router,
                   "--serve-timeout", str(timeout_s)]
    if fused_sample_gather:
        server_args.append("--fused-sample-gather")
    if snapshot_dir:
        server_args += ["--snapshot-dir", snapshot_dir,
                        "--snapshot-every-appends",
                        str(snapshot_every_appends)]
    first_server_args = list(server_args)
    if restart_server_after is not None:
        first_server_args += [
            "--fault-plan",
            f"crash_on_op=append:{restart_server_after},hard=1"]
    procs: Dict[str, subprocess.Popen] = {}
    procs["server"] = spawn(first_server_args)
    try:
        _wait_for_server(port, procs["server"], timeout_s=min(180.0, timeout_s))
        for a in range(n_actors):
            procs[f"actor-{a}"] = spawn(
                ["--mode", "service-actor", *common,
                 "--actor-id", str(a),
                 "--n-envs", str(n_envs),
                 "--warmup", str(warmup),
                 "--actor-chunk", str(actor_chunk),
                 "--epsilon", str(epsilon)])
        learner_args = ["--mode", "service-learner", *common,
                        "--n-envs", str(n_envs),
                        "--learn-steps", str(learn_steps),
                        "--publish-every", str(publish_every)]
        if ckpt_dir:
            learner_args += ["--ckpt-dir", ckpt_dir,
                             "--ckpt-every", str(ckpt_every)]
        if restart_learner_after is not None:
            first = spawn([*learner_args,
                           "--exit-after", str(restart_learner_after)])
            procs["learner-0"] = first
            first.wait(timeout=max(1.0, deadline - time.monotonic()))
            if first.returncode != 0:
                out, _ = first.communicate()
                raise RuntimeError(
                    f"pre-restart learner failed (code {first.returncode}); "
                    f"output tail:\n{_tail(out)}")
            procs["learner"] = spawn([*learner_args, "--resume"])
        else:
            procs["learner"] = spawn(learner_args)
        if restart_server_after is not None:
            first_server = procs.pop("server")
            procs["server-0"] = first_server
            first_server.wait(timeout=max(1.0, deadline - time.monotonic()))
            if first_server.returncode != CRASH_EXIT_CODE:
                out, _ = first_server.communicate()
                raise RuntimeError(
                    f"server did not crash as planned (code "
                    f"{first_server.returncode}, expected "
                    f"{CRASH_EXIT_CODE}); output tail:\n{_tail(out)}")
            # actors and learner are now parked in reconnect backoff;
            # the replacement restores the snapshot onto the SAME port
            # (SO_REUSEADDR) so nobody needs re-addressing
            procs["server"] = spawn([*server_args, "--restore-server"])
            _wait_for_server(port, procs["server"], timeout_s=min(180.0, timeout_s))
    except BaseException:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        raise

    expected_codes = {"server-0": {CRASH_EXIT_CODE}}
    outs: Dict[str, str] = {}
    failed = None
    # a role that dies ends the gang: the others would wait on it (the
    # learner on samples, the actors in backpressure) until their timeouts
    pending = dict(procs)
    while pending:
        for name, p in list(pending.items()):
            if p.poll() is None:
                continue
            outs[name], _ = p.communicate()
            del pending[name]
            if p.returncode != 0 and p.returncode not in expected_codes.get(name, ()):
                failed = failed or (name, f"exit code {p.returncode}")
        if failed is not None or time.monotonic() > deadline:
            failed = failed or (next(iter(pending)), "timeout")
            break
        time.sleep(0.05)
    if failed is not None:
        for name, p in pending.items():
            if p.poll() is None:
                p.kill()
            outs[name], _ = p.communicate()
        name, why = failed
        raise RuntimeError(
            f"replay-service worker {name} failed ({why}); output "
            f"tail:\n{_tail(outs.get(name, ''))}")
    return {name: parse_kv(outs[name]) for name in procs}


# -- worker side -------------------------------------------------------------


def _role_device(args):
    """The role's device: the card unless ``--device cpu`` (raises with no
    GPU), current in this thread; intra-op threads as ``worker_env`` set."""
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    threads = os.environ.get("OMP_NUM_THREADS")
    if threads:
        torch.set_num_threads(max(1, int(threads)))
    return dev


def _dqn_cartpole():
    """The gang's workload: DQN (4, 256, 256, 2) on vectorized CartPole."""
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.envs.classic import make_vec
    from repro_torch.quickstart import transition_example

    env_fn = functools.partial(make_vec, "cartpole")
    spec, _, _ = env_fn(1)
    return env_fn, spec, make_dqn(spec, DQNConfig()), transition_example(spec)


def params_checksum(module) -> float:
    """Σ|p| over the module's parameters, in f64, in parameter order: equal
    checksums of two runs mean the same parameters for every purpose the
    gangs check."""
    return float(sum(p.detach().double().abs().sum().item() for p in module.parameters()))


def _median_spread(samples: Sequence[float]):
    """(median, (max−min)/median): the rel_spread convention of the
    reference's benchmarks, inlined because they are not ported."""
    xs = sorted(samples)
    n = len(xs)
    med = xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])
    return med, ((xs[-1] - xs[0]) / med if med else 0.0)


def _print_launches(state) -> None:
    """This rank's replay kernel launches since its start, and its learner
    calls (0 launches on the CPU: the plain versions run there)."""
    from repro_torch.kernels import ops

    print(f"LEARN_CALLS={state.learn_steps}")
    for name in REPLAY_KERNELS:
        print(f"LAUNCH_{name.upper()}={ops.launch_counts.get(name, 0)}")


def _build_executor(args, device):
    """The gang's workload, the reference's: DQN on CartPole, replay 50,000 ×
    K=128 (divided over the mesh cells), batch 64, warmup 64, ε 0.1;
    ``FusedExecutor`` on one cell, else ``ShardedExecutor`` over a data or
    (pod, data) mesh of the whole gang."""
    import torch.distributed as dist

    from repro_torch.core.distributed import ShardedPrioritizedReplay, ShardedReplayConfig
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.launch.mesh import data_mesh, pod_data_mesh
    from repro_torch.runtime.executors import FusedExecutor, ShardedExecutor
    from repro_torch.runtime.loop import LoopConfig

    env_fn, _, agent, example = _dqn_cartpole()
    cfg = LoopConfig(batch_size=64, warmup=64, epsilon=0.1,
                     update_interval=args.update_interval)
    n_cells = args.n_pods * args.n_data
    if n_cells != dist.get_world_size():
        raise RuntimeError(f"mesh {args.n_pods}x{args.n_data} wants {n_cells} cells but "
                           f"the gang has {dist.get_world_size()} ranks")
    external = args.publish_interval > 0
    if n_cells == 1:
        replay = PrioritizedReplay(ReplayConfig(capacity=50_000, fanout=128), example,
                                   device=device)
        return FusedExecutor(agent, replay, env_fn, cfg, args.n_envs,
                             scan_chunk=args.scan_chunk, device=device,
                             publish_interval=args.publish_interval,
                             external_publish=external)
    if args.n_pods > 1:
        mesh, axes = pod_data_mesh(args.n_pods, args.n_data), ("pod", "data")
    else:
        mesh, axes = data_mesh(args.n_data), ("data",)
    replay = ShardedPrioritizedReplay(
        ShardedReplayConfig(capacity_per_shard=50_000 // n_cells, fanout=128,
                            axis_names=axes), example, device=device)
    return ShardedExecutor(agent, replay, env_fn, cfg, args.n_envs, mesh,
                           scan_chunk=args.scan_chunk,
                           publish_interval=args.publish_interval,
                           compress_pod_reduce=args.compress,
                           overlap_pod_reduce=args.overlap, device=device,
                           external_publish=external)


def _publish_host_roundtrip(ex, state):
    """The wall-clock gang's parameter publish: the fresh learner params go
    device → host (numpy) and back into this rank's acting copy, in place,
    and the age drops to 0.  Replaces the in-step republish
    (``make_step(external_publish=True)``); the agent state is replicated,
    so every rank publishes the same params."""
    import torch

    fresh = ex.agent.params_for_acting(state.agent)
    host = [p.detach().cpu().numpy() for p in fresh.parameters()]
    with torch.no_grad():
        for held, h in zip(state.actor_params.parameters(), host):
            held.copy_(torch.from_numpy(h))
    return state._replace(params_age=0)


def _bench_worker(args, device):
    """``--mode bench``: median env-steps/s over ``--repeats`` timed runs of
    ``--iters`` iterations, after one untimed run."""
    import torch
    import torch.distributed as dist

    ex = _build_executor(args, device)
    publish = args.publish_interval

    def run_iters(state, iters):
        done, metrics = 0, None
        while done < iters:
            length = min(publish or ex.scan_chunk, iters - done)
            with torch.profiler.record_function("wallclock_chunk"):
                state, metrics = ex.run_chunk(state, length)
            if publish:
                state = _publish_host_roundtrip(ex, state)
            done += length
        return state, metrics

    state = ex.init(args.seed)
    state, _ = run_iters(state, args.iters)
    samples = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        state, metrics = run_iters(state, args.iters)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        samples.append(args.n_envs * args.iters / (time.perf_counter() - t0))
    med, spread = _median_spread(samples)
    if dist.get_rank() == 0:
        print(f"STEPS_PER_S={med!r}")
        print(f"REL_SPREAD={spread!r}")
        print(f"REPEATS={args.repeats}")
        print(f"ENV_STEPS={int(metrics['env_steps'])}")
    print(f"DEVICE={device}")
    print(f"PARAMS_AGE={state.params_age}")
    _print_launches(state)


def _fused_worker(args, device):
    """``--mode fused``: ``FusedExecutor.train`` in a gang of one."""
    import torch.distributed as dist

    if dist.get_world_size() != 1:
        raise RuntimeError("--mode fused is the degenerate single-process launch; got "
                           f"{dist.get_world_size()} procs")
    ex = _build_executor(args, device)
    state, hist = ex.train(args.iters, args.seed)
    print(f"FINAL_LOSS={float(hist['loss'][-1])!r}")
    print(f"FINAL_RETURN={float(hist['mean_episode_return'][-1])!r}")
    print(f"ENV_STEPS={int(hist['env_steps'][-1])}")
    print(f"PARAMS_CHECKSUM={params_checksum(state.agent.params)!r}")
    print(f"DEVICE={device}")
    _print_launches(state)


def _equiv_worker(args, device):
    """``--mode equiv``: the overlapped against the barrier cross-pod reduce
    over a real 2-process ``("pod",)`` group, one pod a process, on the
    same per-pod gradient streams (made on every rank from ``--seed``):

      * shift identity — on a constant stream, overlapped event t equals
        barrier event t−1 bit for bit;
      * telescoping — on a varying stream the cumulative applied
        difference collapses to ``p_T − pm_T`` (n_data = 1, so the
        intra-pod partial is the pod's own gradient).

    Rank 0 prints the maxima over both ranks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.learner import make_grad_reducer

    if dist.get_world_size() != 2:
        raise RuntimeError(f"--mode equiv wants a 2-process (pod) gang, got "
                           f"{dist.get_world_size()}")
    mesh = make_mesh(("pod",), (2,))
    barrier = make_grad_reducer(("pod",), mesh, compress_axis="pod")
    overlap = make_grad_reducer(("pod",), mesh, compress_axis="pod", overlap=True)
    T, dim = 8, 16
    rng = np.random.RandomState(args.seed)
    gc_host = rng.randn(2, 1, dim).astype(np.float32)
    gs_host = rng.randn(T, 2, 1, dim).astype(np.float32)
    pod = mesh.axis_index("pod")
    gc = torch.from_numpy(gc_host[pod]).to(device)
    z = torch.zeros_like(gc)

    def b_chain(stream):
        ef, outs = [z], []
        for g in stream:
            out, ef = barrier([g], None, ef)
            outs.append(out[0])
        return outs

    def o_chain(stream):
        ef, outs = {"ef": [z], "prev_mean": [z], "prev_partial": [z]}, []
        for g in stream:
            out, ef = overlap([g], None, ef)
            outs.append(out[0])
        return outs

    const = [gc] * 6
    ob, oo = b_chain(const), o_chain(const)
    shift = torch.stack([torch.max(torch.abs(oo[t] - ob[t - 1])) for t in range(1, 6)]).max()
    varying = [torch.from_numpy(gs_host[t, pod]).to(device) for t in range(T)]
    vb, vo = b_chain(varying), o_chain(varying)
    cum_diff = sum(vo) - sum(vb)
    tele = torch.max(torch.abs(cum_diff - (varying[-1] - vb[-1])))
    errs = torch.stack([shift, tele]).cpu()
    dist.all_reduce(errs, op=dist.ReduceOp.MAX, group=mesh.group("pod"))
    if dist.get_rank() == 0:
        print(f"SHIFT_MAX_ABS_ERR={float(errs[0])!r}")
        print(f"TELESCOPE_MAX_ABS_ERR={float(errs[1])!r}")
        print(f"DEVICE={device}")


def _gang_worker(args):
    """A rank of the wall-clock gang: the device first (raises with no GPU
    unless ``--device cpu``), then the handshake, then the workload; the
    kernels are built before the handshake on the card."""
    import torch.distributed as dist

    from repro_torch.core.distributed import initialize_distributed
    from repro_torch.kernels import ops

    device = _role_device(args)
    if device.type == "cuda":
        ops.build_all()
        ops.reset_launch_counts()
    initialize_distributed(args.coordinator, args.n_procs, args.process_id,
                           timeout_s=args.handshake_timeout, backend=args.backend)
    try:
        {"bench": _bench_worker, "fused": _fused_worker,
         "equiv": _equiv_worker}[args.mode](args, device)
    finally:
        dist.destroy_process_group()


def _replay_server_worker(args):
    """``--mode replay-server``: host the sharded rate-limited service
    until the learner sends stop, then report flow-control stats and the
    replay kernels' launches.  With ``--snapshot-dir`` the service
    snapshots its full state every ``--snapshot-every-appends`` applied
    appends; ``--restore-server`` resumes from the latest snapshot (the
    server-restart drill, DESIGN.md §14); ``--fault-plan`` arms
    deterministic wire faults — a ``hard=1`` crash plan kills this
    process with os._exit(42), so every print before it flushes."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.service import (FaultPlan, RateLimiter, ReplayService,
                                     ReplayServiceConfig, serve)

    device = _role_device(args)
    if device.type == "cuda":
        # a kernel that fails to build raises here, before the port opens
        secs = ops.build_all()
        print(f"BUILD_S={secs!r}", flush=True)
        ops.reset_launch_counts()
    _, _, _, example = _dqn_cartpole()
    spi = args.spi
    # loose gang band: the admission window absorbs the largest single
    # writer burst (a whole actor chunk), not one lockstep loop step
    eb = 2.0 * max(float(args.batch_size), spi * max(1, args.insert_burst))
    limiter = RateLimiter(samples_per_insert=spi,
                          min_size_to_sample=max(1, args.warmup),
                          error_buffer=eb)
    service = ReplayService(
        ReplayServiceConfig(capacity_per_shard=args.capacity_per_shard,
                            n_shards=args.n_shards, fanout=128,
                            fused_sample_gather=args.fused_sample_gather,
                            router=args.router, seed=args.seed),
        example, rate_limiter=limiter, device=device)
    restored_step = None
    if args.snapshot_dir:
        manager = CheckpointManager(args.snapshot_dir, keep=3)
        if args.restore_server:
            restored_step = service.restore_snapshot(manager)
            if restored_step is None:
                raise RuntimeError("--restore-server: no snapshot under "
                                   f"{args.snapshot_dir}")
            print(f"RESTORED_STEP={restored_step}", flush=True)
            restored_calls = service.stats()["sample_calls"]
        service.attach_snapshots(
            manager, every_appends=max(1, args.snapshot_every_appends))
    fault_plan = (FaultPlan.parse(args.fault_plan)
                  if args.fault_plan else None)
    server, port = serve(service, port=args.serve_port,
                         fault_plan=fault_plan)
    print(f"SERVE_PORT={port}", flush=True)
    deadline = time.monotonic() + args.serve_timeout
    while not service.stopped and time.monotonic() < deadline:
        time.sleep(0.1)
    timed_out = not service.stopped
    service.stop()
    time.sleep(2.0)  # grace: parked clients drain their final replies
    server.shutdown()
    st = service.stats()
    rl = st["rate_limiter"]
    denom = max(1, int(rl["inserts"]) - int(rl["min_size_to_sample"]))
    print(f"DEVICE={st['device']}")
    print(f"TREE_BACKEND={st['tree_backend']}")
    print(f"INSERTS={rl['inserts']}")
    print(f"SAMPLES={rl['samples']}")
    print(f"CONFIGURED_SPI={spi!r}")
    print(f"REALIZED_SPI={rl['realized_spi']!r}")
    # the band theorem: |realized − spi| ≤ error_buffer/(inserts − min),
    # i.e. |samples − spi·(inserts − min)| ≤ error_buffer, which the
    # integer counts and these two show exactly (at the band's edge the
    # ratio form can round past its tolerance)
    print(f"SPI_TOLERANCE={eb / denom!r}")
    print(f"ERROR_BUFFER={eb!r}")
    print(f"MIN_SIZE_TO_SAMPLE={rl['min_size_to_sample']}")
    print(f"MEAN_RECENT_RETURN={st['mean_recent_return']!r}")
    print(f"N_RETURNS={st['n_returns']}")
    print("PER_SHARD_COUNT="
          + ",".join(str(c) for c in st["per_shard_count"]))
    print(f"PARAMS_VERSION={st['params_version']}")
    print(f"APPENDS={st['appends']}")
    print(f"DUP_APPENDS={st['dup_appends']}")
    print("WRITER_APPENDS=" + ",".join(
        f"{w}:{n}" for w, n in sorted(st["writer_appends"].items())))
    print(f"SNAPSHOTS={st['snapshots']}")
    print(f"SAMPLE_CALLS={st['sample_calls']}")
    print(f"SAMPLE_HOST_COPIES={st['sample_host_copies']}")
    for name in REPLAY_KERNELS:
        print(f"LAUNCH_{name.upper()}={ops.launch_counts.get(name, 0)}")
    if restored_step is not None:
        print(f"RESTORED_STEP={restored_step}")
        # the samples the snapshot carried over: SAMPLE_CALLS less these
        # are the ones this server served (and launched kernels for)
        print(f"RESTORED_SAMPLE_CALLS={restored_calls}")
    if timed_out:
        raise SystemExit("replay server: no stop received within "
                         f"--serve-timeout {args.serve_timeout:.0f}s")


def _service_actor_worker(args):
    """``--mode service-actor``: run the actor program against the
    service — pull params from the channel, push transition chunks
    through rate-limited appends, until the learner stops the service.
    The ε-schedule clocks off the service's *global* insert counter, so
    the fleet's exploration decays as one actor regardless of how many
    writers share the budget."""
    import numpy as np
    import torch

    from repro_torch.runtime.loop import (LoopConfig, init_actor_slice,
                                          make_actor_program, shard_seed)
    from repro_torch.serve.params import load_params_
    from repro_torch.service.client import (ReplayClient, RetryPolicy,
                                            wait_for_service)

    device = _role_device(args)
    env_fn, _, agent, _ = _dqn_cartpole()
    _, v_reset, v_step = env_fn(args.n_envs)
    cfg = LoopConfig(batch_size=args.batch_size, warmup=args.warmup,
                     epsilon=args.epsilon)
    program = make_actor_program(agent, v_step, cfg, args.n_envs)
    nan = torch.full((args.n_envs,), float("nan"), device=device)

    def rollout(agent_state, sl, gen, env_steps0):
        trans, finished = [], []
        for t in range(args.actor_chunk):
            sl, tr = program(agent_state, sl, gen, env_steps0 + t * args.n_envs)
            trans.append(tr)
            finished.append(torch.where(tr["done"] > 0, sl.last_return, nan))
        # time-major, as the reference's (chunk, n_envs) reshape
        flat = {k: torch.cat([tr[k] for tr in trans]) for k in trans[0]}
        return sl, flat, torch.stack(finished)

    wait_for_service("127.0.0.1", args.serve_port, timeout=60.0)
    client = ReplayClient("127.0.0.1", args.serve_port,
                          timeout=args.rpc_timeout,
                          retry=RetryPolicy(base=0.1, cap=3.0,
                                            deadline=args.retry_deadline,
                                            seed=args.seed + args.actor_id))
    # the learner publishes v1 before sampling — actors start on a real
    # policy, never on their own uninitialized weights
    out = client.get_params(min_version=1, timeout=120.0)
    agent_state = agent.init(torch.Generator(device=device).manual_seed(args.seed))
    load_params_(agent.params_for_acting(agent_state), out["params"])
    have_version = out["version"]

    # one generator an actor, apart by its id, for its envs and its draws
    gen = torch.Generator(device=device)
    gen.manual_seed(shard_seed(args.seed + 1, args.actor_id + 1))
    sl = init_actor_slice(v_reset, gen, args.n_envs)
    env_steps0 = 0
    chunks = transitions = episodes = 0
    while True:
        sl, flat, finished = rollout(agent_state, sl, gen, env_steps0)
        fin = finished.cpu().numpy().ravel()
        rets = [float(r) for r in fin[~np.isnan(fin)]]
        episodes += len(rets)
        reply = client.append(f"actor-{args.actor_id}", flat,
                              returns=rets or None,
                              timeout=args.append_timeout)
        if reply.get("stopped"):
            break
        chunks += 1
        transitions += args.actor_chunk * args.n_envs
        env_steps0 = int(reply["inserts"])
        if reply["params_version"] > have_version:
            try:
                out = client.get_params(min_version=have_version + 1,
                                        timeout=30.0)
            except RuntimeError:
                # graceful degradation (DESIGN.md §14): a restored
                # server's params version can sit briefly below what a
                # pre-crash reply advertised — keep acting on the
                # last-good params; a later reply re-triggers the pull
                continue
            load_params_(agent.params_for_acting(agent_state), out["params"])
            have_version = out["version"]
    client.close()
    print(f"ACTOR_ID={args.actor_id}")
    print(f"DEVICE={device}")
    print(f"CHUNKS={chunks}")
    print(f"TRANSITIONS={transitions}")
    print(f"EPISODES={episodes}")
    print(f"PARAMS_VERSION={have_version}")
    print(f"RECONNECTS={client.reconnects}")
    print(f"ACKED_APPENDS={client.acked_appends}")
    print(f"DEDUPED_APPENDS={client.deduped_appends}")


def _eval_policy(agent, agent_state, env_fn, n_envs: int, steps: int,
                 seed: int, device) -> float:
    """Near-greedy rollout of the learned policy (fresh envs, no replay):
    mean return over every episode that finishes in the window, plus the
    censored running return of any env that outlives the whole window —
    a policy good enough to never terminate must not score 0.0."""
    import numpy as np
    import torch

    from repro_torch.runtime.loop import (LoopConfig, init_actor_slice,
                                          make_actor_program)

    _, v_reset, v_step = env_fn(n_envs)
    cfg = LoopConfig(epsilon=0.01, epsilon_final=0.01)
    program = make_actor_program(agent, v_step, cfg, n_envs)
    gen = torch.Generator(device=device).manual_seed(seed)
    sl = init_actor_slice(v_reset, gen, n_envs)
    nan = torch.full((n_envs,), float("nan"), device=device)
    fin = []
    for _ in range(steps):
        sl, tr = program(agent_state, sl, gen, 0)
        fin.append(torch.where(tr["done"] > 0, sl.last_return, nan))
    fin = torch.stack(fin).cpu().numpy()          # (steps, n_envs); NaN = alive
    finished = fin[~np.isnan(fin)]
    # an env with no completed episode in the window (CartPole's 500-step
    # limit exceeds the 250-step eval window, so a strong policy finishes
    # nothing) is scored by its running return — a lower bound, not a 0
    never_done = ~np.any(~np.isnan(fin), axis=0)
    censored = sl.episode_return.cpu().numpy()[never_done]
    rets = np.concatenate([finished, censored])
    return float(rets.mean()) if rets.size else 0.0


def _service_learner_worker(args):
    """``--mode service-learner``: the sampler side — publish params,
    drain rate-limited samples through the learner program, write
    priorities back, checkpoint periodically, and stop the service when
    the learn budget is spent.  With ``--exit-after`` the process
    checkpoints and exits mid-run *without* stopping the service (the
    restart drill); with ``--resume`` it restores the latest checkpoint
    and continues the count."""
    import torch

    from repro_torch.agents.base import load_generators, state_tensors
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.runtime.loop import make_learner_program
    from repro_torch.service.client import (ReplayClient, RetryPolicy,
                                            wait_for_service)

    device = _role_device(args)
    env_fn, _, agent, _ = _dqn_cartpole()
    learn = make_learner_program(agent)
    agent_state = agent.init(torch.Generator(device=device).manual_seed(args.seed))
    step0 = 0
    manager = None
    if args.ckpt_dir:
        manager = CheckpointManager(args.ckpt_dir, keep=3)
        if args.resume:
            tensors = state_tensors(agent_state)
            step, _ = manager.restore_latest(tensors)
            if step is None:
                raise RuntimeError(
                    f"--resume: no checkpoint under {args.ckpt_dir}")
            load_generators(agent_state, tensors)
            step0 = step
            print(f"RESUMED_FROM={step0}", flush=True)
    if args.exit_after and manager is None:
        raise RuntimeError("--exit-after requires --ckpt-dir (the resumed "
                           "learner restores from the checkpoint)")

    wait_for_service("127.0.0.1", args.serve_port, timeout=60.0)
    client = ReplayClient("127.0.0.1", args.serve_port,
                          timeout=args.rpc_timeout,
                          retry=RetryPolicy(base=0.1, cap=3.0,
                                            deadline=args.retry_deadline,
                                            seed=args.seed + 1000))
    client.put_params(agent.params_for_acting(agent_state))

    def save(step):
        manager.save(step, state_tensors(agent_state))

    learn_step = step0
    last_loss = torch.full((), float("nan"))
    t0 = None
    # where a learn step's wall goes, from the first sample on: the sample
    # round trip (its rows onto the device included), the learn call up to
    # its TD errors on the host (a sync), the write-back's round trip
    split = {"sample": 0.0, "learn": 0.0, "update": 0.0}
    while learn_step < args.learn_steps:
        try:
            ta = time.perf_counter()
            out = client.sample(args.batch_size, beta=0.4,
                                timeout=args.rpc_timeout)
            if out.get("stopped"):
                break
            if t0 is None:
                t0 = ta
            items = {k: torch.as_tensor(v).to(device) for k, v in out["items"].items()}
            weights = torch.as_tensor(out["weights"]).to(device)
            tb = time.perf_counter()
            agent_state, metrics, td = learn(agent_state, items, weights)
            td = td.cpu().numpy()
            tc = time.perf_counter()
            client.update_priorities(out["sample_id"], td)
            split["sample"] += tb - ta
            split["learn"] += tc - tb
            split["update"] += time.perf_counter() - tc
            learn_step += 1
            last_loss = metrics["loss"]
            if learn_step % args.publish_every == 0:
                client.put_params(agent.params_for_acting(agent_state))
        except ConnectionError:
            # bounded degradation (DESIGN.md §14): the client already
            # spent its full reconnect-retry budget — the service is
            # gone for good.  Checkpoint what we have and exit cleanly
            # instead of hanging the gang.
            if manager is not None:
                save(learn_step)
            client.close()
            print(f"LEARN_STEPS={learn_step}")
            print(f"FINAL_LOSS={float(last_loss)!r}")
            print("SAMPLE_RETRY_EXHAUSTED=1")
            return
        if manager is not None and args.ckpt_every \
                and learn_step % args.ckpt_every == 0:
            save(learn_step)
        if args.exit_after and learn_step - step0 >= args.exit_after \
                and learn_step < args.learn_steps:
            # planned mid-run exit: checkpoint, leave the service up —
            # actors park in writer backpressure until the resumed
            # learner's samples pay the debt back down
            save(learn_step)
            client.close()
            print(f"LEARN_STEPS={learn_step}")
            print("EXITED_EARLY=1")
            return
    wall = time.perf_counter() - t0 if t0 is not None else 0.0
    done = learn_step - step0

    client.put_params(agent.params_for_acting(agent_state))
    if manager is not None and args.ckpt_every:
        save(learn_step)
    stats = client.stats()
    eval_ret = _eval_policy(agent, agent_state, env_fn, n_envs=8,
                            steps=250, seed=args.seed + 7, device=device)
    client.stop()
    client.close()
    rl = stats.get("rate_limiter", {})
    print(f"DEVICE={device}")
    print(f"LEARN_STEPS={learn_step}")
    print(f"FINAL_LOSS={float(last_loss)!r}")
    print(f"EVAL_RETURN={eval_ret!r}")
    print(f"PARAMS_CHECKSUM={params_checksum(agent_state.params)!r}")
    print(f"MEAN_RECENT_RETURN={stats['mean_recent_return']!r}")
    print(f"SERVICE_INSERTS={stats['inserts']}")
    print(f"SERVICE_SAMPLES={stats['samples']}")
    print(f"REALIZED_SPI={rl.get('realized_spi', 0.0)!r}")
    print(f"LEARN_WALL_S={wall!r}")
    print(f"WALL_PER_LEARN_MS={(wall / done * 1e3 if done else math.nan)!r}")
    for name, secs in split.items():
        print(f"{name.upper()}_MS_PER_LEARN={(secs / done * 1e3 if done else math.nan)!r}")


# -- entry -------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="wall-clock gang rank (spawned by launch()) or replay-service "
                    "role (spawned by launch_service())")
    ap.add_argument("--mode", choices=GANG_MODES + SERVICE_ROLES, default="bench")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--n-envs", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    # the wall-clock gang (DESIGN.md §10)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of the process group's rendezvous (rank 0 binds "
                         "it); required by the gang modes, unused by the service roles")
    ap.add_argument("--n-procs", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--handshake-timeout", type=float, default=HANDSHAKE_TIMEOUT_S)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo",
                    help="torch.distributed backend: gloo for ranks that share a card")
    ap.add_argument("--n-pods", type=int, default=1)
    ap.add_argument("--n-data", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--overlap", action="store_true")
    ap.add_argument("--publish-interval", type=int, default=0)
    ap.add_argument("--update-interval", type=int, default=1)
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--scan-chunk", type=int, default=20)
    # replay-service roles (DESIGN.md §11)
    ap.add_argument("--serve-port", type=int, default=0)
    ap.add_argument("--n-shards", type=int, default=1)
    ap.add_argument("--spi", type=float, default=16.0,
                    help="configured samples-per-insert ratio")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--warmup", type=int, default=512)
    ap.add_argument("--capacity-per-shard", type=int, default=20_000)
    ap.add_argument("--insert-burst", type=int, default=64,
                    help="largest single writer append the band absorbs")
    ap.add_argument("--router", choices=("hash", "round_robin"), default="hash")
    ap.add_argument("--fused-sample-gather", action="store_true",
                    help="server: sample each shard with the fused "
                         "sample+gather kernel (#3)")
    ap.add_argument("--serve-timeout", type=float, default=600.0)
    ap.add_argument("--actor-id", type=int, default=0)
    ap.add_argument("--actor-chunk", type=int, default=8,
                    help="env steps per actor rollout / append")
    ap.add_argument("--epsilon", type=float, default=0.2)
    ap.add_argument("--learn-steps", type=int, default=1200)
    ap.add_argument("--publish-every", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--exit-after", type=int, default=0,
                    help="learner: checkpoint and exit after this many "
                         "learn steps without stopping the service")
    ap.add_argument("--resume", action="store_true",
                    help="learner: restore the latest checkpoint")
    ap.add_argument("--rpc-timeout", type=float, default=300.0)
    ap.add_argument("--append-timeout", type=float, default=240.0)
    ap.add_argument("--retry-deadline", type=float, default=180.0,
                    help="client reconnect-retry budget per call — must "
                         "cover a full server restart (torch import and "
                         "CUDA start included)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="server: shard-snapshot directory (DESIGN.md §14)")
    ap.add_argument("--snapshot-every-appends", type=int, default=0,
                    help="server: snapshot period in applied appends "
                         "(1 = durable acks, the restart drill setting)")
    ap.add_argument("--restore-server", action="store_true",
                    help="server: restore the latest shard snapshot from "
                         "--snapshot-dir before serving")
    ap.add_argument("--fault-plan", default=None,
                    help="server: FaultPlan.parse spec, e.g. "
                         "'crash_on_op=append:40,hard=1'")
    args = ap.parse_args(argv)

    if args.mode in GANG_MODES:
        from repro_torch.device import resolve_device

        resolve_device(args.device)     # no GPU and no --device cpu: raise first
        if args.coordinator is None:
            ap.error("--coordinator is required for modes bench/fused/equiv")
        _gang_worker(args)
        return
    # service roles never join a process group: independent runtimes
    # meeting only at the TCP boundary
    {"replay-server": _replay_server_worker,
     "service-actor": _service_actor_worker,
     "service-learner": _service_learner_worker}[args.mode](args)


if __name__ == "__main__":
    main()
