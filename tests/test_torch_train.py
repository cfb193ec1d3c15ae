"""The port's training entry point (``python -m repro_torch.launch.train``)
on the CPU at SMOKE size: it trains through the flash path, checkpoints,
resumes from its checkpoint, applies a planner's plan, and refuses model
sharding (``--mesh``), which is not ported.  ``--wall-clock`` is in
tests/test_torch_gang.py."""

import pytest
import torch

from repro_torch.agents import token_dqn
from repro_torch.agents.base import state_tensors
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train

torch.set_num_threads(2)

ARGS = ["--arch", "internlm2_1_8b", "--smoke", "--device", "cpu", "--seq", "128",
        "--attn-impl", "flash", "--ckpt-every", "2", "--n-envs", "4", "--batch", "4"]


def counting(monkeypatch):
    """Count the flash forward and backward calls (the kernels' plain
    versions on the CPU)."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_bwd

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_fwd", count_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd", count_bwd)
    return calls


def test_trains_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    calls = counting(monkeypatch)
    ckpt = ["--ckpt-dir", str(tmp_path)]
    res = train.main(ARGS + ckpt + ["--steps", "4"])
    layers = res["cfg"].num_layers
    assert res["start"] is None and [h["step"] for h in res["history"]] == [0, 1, 2, 3]
    # online + target forward and one backward per attention layer per
    # step; the collect's 8-token context never takes flash
    assert calls == {"fwd": 2 * layers * 4, "bwd": layers * 4}
    for h in res["history"]:
        assert all(torch.isfinite(torch.tensor(h[k])) for k in ("loss", "grad_norm", "q_mean"))
        assert 0.0 <= h["reward"] <= 1.0
    assert 0.0 < res["optimal_reward"] < 1.0
    assert res["root_after_flush"] != res["root_before_flush"]
    state = res["state"]
    assert int(state.step) == 4
    assert any(not torch.equal(p.detach(), t) for p, t in
               zip(state.params.parameters(), state.target.parameters()))
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    # the checkpoint of step 4 is the final state, bit for bit
    fresh = token_dqn.init_train_state(res["cfg"], res["tcfg"], torch.Generator().manual_seed(9))
    got = CheckpointManager(str(tmp_path)).restore(4, state_tensors(fresh))
    for k, t in state_tensors(state).items():
        assert torch.equal(got[k], t), k
    capsys.readouterr()

    res2 = train.main(ARGS + ckpt + ["--steps", "6"])
    assert "resumed from step 4" in capsys.readouterr().out
    assert res2["start"] == 4 and [h["step"] for h in res2["history"]] == [4, 5]
    assert int(res2["state"].step) == 6
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 6]


@pytest.mark.parametrize("flag", [["--mesh", "16x16"]])
def test_unported_modes_exit_2(flag, capsys):
    with pytest.raises(SystemExit) as e:
        train.main(ARGS + flag)
    assert e.value.code == 2
    assert "ROADMAP Queue 1 item 21" in capsys.readouterr().err


def test_plan_applies_the_planned_env_count(tmp_path, capsys):
    """``--plan``: the plan's n_envs replaces --n-envs (one segment of each
    actor lands in the replay a step) and the run names the planned mesh;
    it stays one process, as the reference's unsharded planned run does."""
    from repro_torch.runtime import planner

    pc = planner.PlannedConfig(backend="sharded", n_data=2, n_envs=6,
                               predicted_env_steps_per_s=10.0, source="test")
    planner.save_plan(pc, str(tmp_path / "BENCH_plan.json"))
    res = train.main(ARGS + ["--plan", str(tmp_path / "BENCH_plan.json"), "--steps", "2",
                             "--ckpt-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert res["plan"] == pc
    assert f"plan: {pc.describe()}" in out and "mesh=plan:1x2" in out
    assert res["replay_state"].count == 2 * pc.n_envs
    with pytest.raises(SystemExit) as e:
        train.main(ARGS + ["--plan", str(tmp_path / "BENCH_plan.json"), "--mesh", "16x16"])
    assert e.value.code == 2


def test_needs_cuda_unless_cpu_requested(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in ARGS if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(args + ["--ckpt-dir", str(tmp_path), "--steps", "1"])
