"""The port stands alone: no module of src/repro_torch and not
chip_smoke.py imports jax, jaxlib or the JAX package, and its entry
points refuse to run without a GPU unless asked for the CPU."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
# "benchmarks": the reference's sweeps, which import jax; the port keeps
# its own (runtime/sweeps.py)
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + [
        REPO / "tools" / name for name in ("chaos_drill_torch.py", "repro_lint_torch.py")]


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0], node.lineno


def test_no_jax_or_reference_import_in_source():
    files = _port_files()
    assert len(files) > 15
    bad = [f"{p.relative_to(REPO)}:{line} imports {root}"
           for p in files for root, line in _imported_roots(p) if root in FORBIDDEN]
    assert not bad, bad


def test_importing_every_module_loads_no_jax():
    # a subprocess: tests/conftest.py has already imported jax here
    mods = [".".join(p.relative_to(REPO / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in {FORBIDDEN!r})
        assert not bad, bad
        print(len({mods!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) == len(mods)


def test_entry_points_need_cuda_unless_cpu_requested(monkeypatch):
    from repro_torch import quickstart
    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.core.replay import PrioritizedReplay, ReplayConfig
    from repro_torch.envs.classic import make_vec
    from repro_torch.runtime.executors import FusedExecutor
    from repro_torch.runtime.loop import LoopConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, _, _ = make_vec("cartpole", 1)
    example = quickstart.transition_example(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrioritizedReplay(ReplayConfig(capacity=64, fanout=8), example)
    replay = PrioritizedReplay(ReplayConfig(capacity=64, fanout=8), example,
                               device="cpu")
    env_fn = lambda n: make_vec("cartpole", n)  # noqa: E731
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedExecutor(make_dqn(spec, DQNConfig()), replay, env_fn, LoopConfig(), 4)
    with pytest.raises(RuntimeError, match="--device cpu"):
        quickstart.main(["--iterations", "2"])
    FusedExecutor(make_dqn(spec, DQNConfig()), replay, env_fn, LoopConfig(), 4,
                  device="cpu")   # an explicit CPU request runs


def test_quickstart_runs_on_cpu_when_asked(capsys):
    from repro_torch import quickstart
    state, hist = quickstart.main(["--device", "cpu", "--iterations", "70",
                                   "--n-envs", "8", "--fused-sample-gather",
                                   "--backend", "cuda"])
    # warmup 500: iterations 63..69 learn, 8 learner calls each
    assert state.env_steps == 560 and state.learn_steps == 7 * 8
    assert "tree backend cuda" in capsys.readouterr().out


@pytest.mark.parametrize("rel", ["runtime/dse.py", "runtime/planner.py",
                                 "launch/multiprocess.py", "runtime/sweeps.py",
                                 "dse_autotune.py", "launch/chaos_drill.py"])
def test_dse_planner_and_gang_import_no_jax(rel):
    """The modules copied from the reference's jax-free ones and the gang
    launcher import nothing of it: the AST scan, and a fresh interpreter
    that imports the module alone."""
    path = PORT / rel
    bad = [f"{rel}:{line} imports {root}" for root, line in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, bad
    mod = "repro_torch." + rel[:-3].replace("/", ".")
    code = (f"import importlib, sys; importlib.import_module({mod!r}); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120, cwd=str(REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_service_roles_need_cuda_unless_cpu_requested(monkeypatch):
    """Each replay-service role, each wall-clock gang mode, both launchers
    and the service itself raise without a GPU unless asked for the CPU."""
    from repro_torch.launch import multiprocess as mp
    from repro_torch.service import ReplayService, ReplayServiceConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for role in mp.SERVICE_ROLES:
        with pytest.raises(RuntimeError, match="--device cpu"):
            mp.main(["--mode", role, "--serve-port", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mp.launch_service(n_actors=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReplayService(ReplayServiceConfig(capacity_per_shard=8),
                      {"obs": np.zeros((2,), np.float32)})
    for mode in mp.GANG_MODES:
        with pytest.raises(RuntimeError, match="--device cpu"):
            mp.main(["--mode", mode, "--coordinator", "127.0.0.1:1"])
        with pytest.raises(RuntimeError, match="--device cpu"):
            mp.main(["--mode", mode])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mp.launch(["--mode", "equiv"], n_procs=2)
    from repro_torch.launch import chaos_drill
    from repro_torch.runtime import sweeps

    with pytest.raises(RuntimeError, match="device='cpu'"):
        chaos_drill.run_drill(learn_steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweeps.shard_pod_points(shard_counts=(1,), pod_specs=())
    for fn in (sweeps.actor_throughput, sweeps.learner_throughput):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweeps.executor_backend_points(publish_intervals=())
