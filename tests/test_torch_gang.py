"""The port's wall-clock gang (repro_torch.launch.multiprocess: ``launch``,
``run_gang``, ``--mode bench|fused|equiv``; ``core.distributed.
initialize_distributed``; ``make_step(external_publish=True)``;
``launch/train.py --wall-clock``) on the CPU — ports of
tests/test_multiprocess.py, tests/test_distributed.py's gang test and the
reference's external-publish contract.

Each gang is a set of real OS processes, ranks of a gloo process group
joined over ``tcp://`` (``--device cpu``).  Tolerances: the degenerate
1-process launch ≡ the in-process ``FusedExecutor`` bit for bit (loss,
return, env steps, parameter checksum); the overlapped against the
barrier reduce at the reference's limits (shift error exactly 0,
telescoping error < 1e-6, tests/test_distributed.py); the host
round-trip publish ≡ the in-step publish bit for bit; the averaged
parameters bit for bit the f32 mean of the ranks' parameters, and equal
on every worker.
"""

import functools
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from repro_torch.agents.base import state_tensors
from repro_torch.agents.dqn import DQNConfig, make_dqn
from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
from repro_torch.envs.classic import make_vec
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import multiprocess as mp
from repro_torch.launch import train
from repro_torch.quickstart import transition_example
from repro_torch.runtime.executors import FusedExecutor
from repro_torch.runtime.loop import LoopConfig, make_step

CARTPOLE = functools.partial(make_vec, "cartpole")


def test_parse_kv_matches_reference():
    from repro.launch import multiprocess as ref

    text = ("garbage\nSTEPS_PER_S=12.5\nnoise a=b\nlower=skipped\n"
            "STEPS_PER_S=13.0\nREL_SPREAD=0.01\n")
    assert mp.parse_kv(text) == ref.parse_kv(text) == {"STEPS_PER_S": "13.0",
                                                       "REL_SPREAD": "0.01"}


def test_launch_rejects_empty_gang_and_needs_cuda(monkeypatch):
    from repro.launch import multiprocess as ref

    for mod in (mp, ref):
        with pytest.raises(ValueError, match="n_procs"):
            mod.launch(["--mode", "fused"], n_procs=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mp.launch(["--mode", "fused"], n_procs=1)


def test_handshake_timeout_raises_clear_error_not_hang():
    """A rank whose coordinator never comes up (rank 0 missing from the
    gang) exits with the initialize_distributed error naming the
    coordinator, within its handshake timeout, not a hang."""
    port = mp.free_port()   # bound by nobody: the handshake cannot succeed
    cmd = [sys.executable, "-m", "repro_torch.launch.multiprocess",
           "--coordinator", f"127.0.0.1:{port}", "--n-procs", "2", "--process-id", "1",
           "--handshake-timeout", "8", "--device", "cpu", "--mode", "fused", "--iters", "1"]
    t0 = time.monotonic()
    res = subprocess.run(cmd, env=mp.worker_env(1), capture_output=True, text=True,
                         timeout=180)
    elapsed = time.monotonic() - t0
    assert res.returncode != 0
    out = res.stdout + res.stderr
    assert "coordinator handshake failed: process 1/2" in out, out[-2000:]
    assert f"127.0.0.1:{port}" in out
    assert elapsed < 60, elapsed      # 8 s and the interpreter's start


def test_failing_worker_surfaces_and_the_gang_is_killed():
    """A rank that exits non-zero ends the gang at once: the error names it
    with its output tail, and a rank still running is killed, not waited
    for."""
    sleeper = [sys.executable, "-c", "import time; time.sleep(300)"]
    failer = [sys.executable, "-c", "print('about to fail'); raise SystemExit(3)"]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"wall-clock worker 1/2 failed \(exit code 3\)"
                                           r"[\s\S]*about to fail"):
        mp.run_gang([sleeper, failer], [mp.worker_env(2)] * 2, timeout_s=120)
    assert time.monotonic() - t0 < 60
    # the real launcher: --mode fused refuses a gang of two after the handshake
    with pytest.raises(RuntimeError, match="wall-clock worker") as e:
        mp.launch(["--mode", "fused", "--iters", "1"], n_procs=2, timeout_s=300.0,
                  device="cpu")
    assert "degenerate single-process launch" in str(e.value)


@pytest.fixture
def two_cores(monkeypatch):
    """``worker_env`` gives each rank ``cpu_count // n_procs`` threads; two
    "cores" keep a gang from oversubscribing a machine that runs other
    tests beside it."""
    monkeypatch.setattr(os, "cpu_count", lambda: 2)


def _gang_threads() -> int:
    return int(mp.worker_env(1)["OMP_NUM_THREADS"])


def test_fused_mode_bit_exact_vs_in_process(two_cores):
    """The degenerate launch: one rank through the full handshake runs the
    exact FusedExecutor program — final loss, return, env steps and a
    parameter checksum equal the same executor's in process, bit for bit
    (the reference's settings, tests/test_multiprocess.py), at the rank's
    thread count."""
    iters, n_envs, scan_chunk, seed = 30, 8, 10, 0
    out = mp.launch(["--mode", "fused", "--iters", str(iters), "--n-envs", str(n_envs),
                     "--scan-chunk", str(scan_chunk), "--seed", str(seed)],
                    n_procs=1, timeout_s=600.0, device="cpu")
    kv = mp.parse_kv(out[0])
    threads = torch.get_num_threads()
    torch.set_num_threads(_gang_threads())      # the rank's intra-op threads
    try:
        spec, _, _ = CARTPOLE(1)
        cfg = LoopConfig(batch_size=64, warmup=64, epsilon=0.1)
        replay = PrioritizedReplay(ReplayConfig(capacity=50_000, fanout=128),
                                   transition_example(spec), device="cpu")
        ex = FusedExecutor(make_dqn(spec, DQNConfig()), replay, CARTPOLE, cfg, n_envs,
                           scan_chunk=scan_chunk, device="cpu")
        state, hist = ex.train(iters, seed)
    finally:
        torch.set_num_threads(threads)
    assert float(kv["FINAL_LOSS"]) == float(hist["loss"][-1])
    assert float(kv["FINAL_RETURN"]) == float(hist["mean_episode_return"][-1])
    assert int(kv["ENV_STEPS"]) == int(hist["env_steps"][-1]) == iters * n_envs
    assert float(kv["PARAMS_CHECKSUM"]) == mp.params_checksum(state.agent.params)
    assert int(kv["LEARN_CALLS"]) == state.learn_steps > 0
    assert kv["DEVICE"] == "cpu" and kv["LAUNCH_SUMTREE_SAMPLE"] == "0"


def test_equiv_mode_meets_reference_limits(two_cores):
    """tests/test_distributed.py's two-process gang: the overlapped and the
    barrier cross-pod reduce over a real ("pod",) group of 2 processes."""
    out = mp.launch(["--mode", "equiv", "--seed", "0"], n_procs=2, timeout_s=600.0,
                    device="cpu")
    kv = mp.parse_kv(out[0])
    assert float(kv["SHIFT_MAX_ABS_ERR"]) == 0.0
    assert float(kv["TELESCOPE_MAX_ABS_ERR"]) < 1e-6


@pytest.mark.parametrize("publish", [0, 3])
def test_bench_mode_on_a_two_rank_data_mesh(publish, two_cores):
    iters, repeats, n_envs = 12, 2, 8
    out = mp.launch(["--mode", "bench", "--n-data", "2", "--n-envs", str(n_envs),
                     "--iters", str(iters), "--repeats", str(repeats), "--scan-chunk", "6",
                     "--publish-interval", str(publish)],
                    n_procs=2, timeout_s=600.0, device="cpu")
    kv = [mp.parse_kv(o) for o in out]
    assert float(kv[0]["STEPS_PER_S"]) > 0.0 and float(kv[0]["REL_SPREAD"]) >= 0.0
    assert int(kv[0]["REPEATS"]) == repeats
    assert int(kv[0]["ENV_STEPS"]) == (1 + repeats) * iters * n_envs
    assert "STEPS_PER_S" not in kv[1]
    assert kv[0]["LEARN_CALLS"] == kv[1]["LEARN_CALLS"] and int(kv[0]["LEARN_CALLS"]) > 0
    # the host publish after every chunk of P iterations leaves age 0
    assert kv[0]["PARAMS_AGE"] == kv[1]["PARAMS_AGE"] == "0"


def test_external_publish_needs_publish_interval():
    from repro.runtime.loop import make_step as ref_make_step

    spec, _, v_step = CARTPOLE(4)
    agent = make_dqn(spec, DQNConfig(hidden=(8,)))
    replay = PrioritizedReplay(ReplayConfig(capacity=64, fanout=8), transition_example(spec),
                               device="cpu")
    with pytest.raises(ValueError) as got:
        make_step(agent, replay, v_step, LoopConfig(), 4, external_publish=True)
    with pytest.raises(ValueError) as want:
        ref_make_step(None, None, None, None, 4, external_publish=True)
    assert str(got.value) == str(want.value)


def test_host_roundtrip_publish_equals_in_step_publish():
    """``external_publish`` + the gang's host round trip after every chunk
    of P iterations ≡ the in-step publish at the same ticks: the acting
    copy, its age and the whole state bit for bit."""
    spec, _, _ = CARTPOLE(1)
    agent = make_dqn(spec, DQNConfig(hidden=(32, 32)))
    cfg = LoopConfig(batch_size=32, warmup=8, epsilon=0.2)
    P = 3

    def executor(external):
        replay = PrioritizedReplay(ReplayConfig(capacity=512, fanout=8),
                                   transition_example(spec), device="cpu")
        return FusedExecutor(agent, replay, CARTPOLE, cfg, 4, device="cpu",
                             publish_interval=P, external_publish=external)

    ex_in, ex_ext = executor(False), executor(True)
    a, b = ex_in.init(5), ex_ext.init(5)
    learned = 0
    for _ in range(6):
        a, _ = ex_in.run_chunk(a, P)
        b, _ = ex_ext.run_chunk(b, P)
        assert a.params_age == 0 and b.params_age == P
        b = mp._publish_host_roundtrip(ex_ext, b)
        assert b.params_age == 0
        for x, y in zip(a.actor_params.parameters(), b.actor_params.parameters()):
            assert torch.equal(x, y)
        ta, tb = state_tensors(a.agent), state_tensors(b.agent)
        assert all(torch.equal(ta[k], tb[k]) for k in ta)
        learned = a.learn_steps
    assert learned > 0 and a.learn_steps == b.learn_steps
    # the copy is not the learner's module: the publish copied, not aliased
    fresh = list(agent.params_for_acting(b.agent).parameters())
    assert all(x.data_ptr() != y.data_ptr() for x, y in zip(b.actor_params.parameters(), fresh))


def _averager_rank(rank: int) -> dict:
    gen = torch.Generator().manual_seed(100 + rank)
    module = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Linear(7, 3))
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    before = [p.detach().clone() for p in module.parameters()]
    train.make_param_averager(2)(module)
    return {"before": before, "after": [p.detach().clone() for p in module.parameters()]}


def test_param_averager_is_the_f32_mean():
    a, b = meshlib.spawn(_averager_rank, 2, backend="gloo", device="cpu", timeout_s=300)
    for x0, y0, x1, y1 in zip(a["before"], b["before"], a["after"], b["after"]):
        assert not torch.equal(x0, y0)
        assert torch.equal(x1, y1) and torch.equal(x1, (x0 + y0) / 2)


def test_wall_clock_train_two_workers(tmp_path, two_cores):
    """``launch.train --wall-clock 2`` on the CPU: two worker processes, each
    on half the actors, their parameters averaged after every step; both
    print ``arch=``, worker 0 the steps and ``trained N steps`` and writes
    the checkpoints; after the last average the workers' parameters are
    equal, and their sum the mean of the workers' sums before it."""
    steps = 3
    res = train.main(["--arch", "granite_8b", "--smoke", "--device", "cpu", "--seq", "128",
                      "--attn-impl", "flash", "--n-envs", "4", "--batch", "4",
                      "--steps", str(steps), "--ckpt-every", "2", "--ckpt-dir", str(tmp_path),
                      "--wall-clock", "2"])
    outs = res["workers"]
    assert len(outs) == 2
    kv = [mp.parse_kv(o) for o in outs]
    assert all("arch=granite-smoke" in o for o in outs)
    assert f"trained {steps} steps" in outs[0] and "trained" not in outs[1]
    assert len(re.findall(r"^step ", outs[0], re.M)) == steps
    assert not re.findall(r"^step ", outs[1], re.M)
    assert [int(k["WORKER"]) for k in kv] == [0, 1]
    assert all(int(k["STEPS"]) == steps for k in kv)
    assert kv[0]["PARAMS_CHECKSUM"] == kv[1]["PARAMS_CHECKSUM"]
    assert kv[0]["PARAMS_SUM"] == kv[1]["PARAMS_SUM"]
    pre = [float(k["PRE_AVERAGE_SUM"]) for k in kv]
    assert pre[0] != pre[1]      # the workers' own actor streams
    assert float(kv[0]["PARAMS_SUM"]) == pytest.approx(sum(pre) / 2, rel=0, abs=1e-4)
    from repro_torch.checkpoint.manager import CheckpointManager
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, steps]


def test_wall_clock_refuses_plan_and_mesh(tmp_path):
    for flag in (["--plan", str(tmp_path / "p.json")], ["--mesh", "16x16"]):
        with pytest.raises(SystemExit) as e:
            train.main(["--smoke", "--device", "cpu", "--wall-clock", "2", *flag])
        assert e.value.code == 2


def test_wall_clock_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--smoke", "--wall-clock", "2"])
    assert os.environ.get(train.WC_COORD) is None
