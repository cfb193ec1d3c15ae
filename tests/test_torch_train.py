"""The port's training entry point (``python -m repro_torch.launch.train``)
on the CPU at SMOKE size: it trains through the flash path, checkpoints,
resumes from its checkpoint, applies a planner's plan, runs ``--mesh
16x16`` and ``2x16x16`` as the reference's one-process run (bit for bit
``--mesh host`` on a dense arch; per-shard moe routing with
``moe_local_dispatch``); it trains the hybrid (Hymba, flash) and ssm
(xLSTM) families.  ``--wall-clock`` is in tests/test_torch_gang.py."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.agents import token_dqn
from repro_torch.agents.base import state_tensors
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train
from repro_torch.models import moe

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
    # online + target forward, the remat's recompute of the online one
    # (cfg.remat) and one backward per attention layer per step; the
    # collect's 8-token context never takes flash
    assert res["cfg"].remat
    assert calls == {"fwd": 3 * layers * 4, "bwd": layers * 4}
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


@pytest.mark.parametrize("arch,flash_layers", [("hymba_1_5b", 2), ("xlstm_125m", 0)])
def test_trains_the_hybrid_and_ssm_families(arch, flash_layers, tmp_path, monkeypatch):
    """Three steps at SMOKE from the entry point: finite losses, a moved
    online network, the final checkpoint; Hymba's attention through the
    flash path as the code predicts (online, target and the remat's
    recompute forward, one backward, a layer a step), xLSTM with none."""
    calls = counting(monkeypatch)
    res = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--seq", "128",
                      "--attn-impl", "flash", "--n-envs", "4", "--batch", "4", "--steps", "3",
                      "--ckpt-dir", str(tmp_path)])
    assert res["cfg"].family == ("hybrid" if arch == "hymba_1_5b" else "ssm")
    assert [h["step"] for h in res["history"]] == [0, 1, 2]
    for h in res["history"]:
        assert all(torch.isfinite(torch.tensor(h[k])) for k in ("loss", "grad_norm", "q_mean"))
    assert calls == {"fwd": 3 * flash_layers * 3, "bwd": flash_layers * 3}
    state = res["state"]
    assert any(not torch.equal(p.detach(), t) for p, t in
               zip(state.params.parameters(), state.target.parameters()))
    assert CheckpointManager(str(tmp_path)).all_steps() == [3]


def local_dispatch_keep(expert_id: np.ndarray, shards: int, cap: int) -> np.ndarray:
    """The reference's per-shard keep rule (``repro/models/moe.py:80-100``):
    the T tokens in ``shards`` consecutive shards; a token's rank at a top-k
    slot counts the earlier tokens of its shard routed to the same expert
    at that slot; it is kept when its rank is below the capacity."""
    t, k = expert_id.shape
    keep = np.zeros((t, k), bool)
    for i in range(shards):
        part = expert_id[i * (t // shards):(i + 1) * (t // shards)]
        for j in range(k):
            seen = {}
            for row, e in enumerate(part[:, j]):
                keep[i * (t // shards) + row, j] = seen.get(e, 0) < cap
                seen[e] = seen.get(e, 0) + 1
    return keep


@pytest.mark.parametrize("arch,mesh", [("internlm2_1_8b", "16x16"),
                                       ("internlm2_1_8b", "2x16x16"),
                                       ("mixtral_8x7b", "16x16")])
def test_mesh_runs_as_the_reference(arch, mesh, tmp_path, monkeypatch, capsys):
    """``--mesh 16x16|2x16x16`` runs one process with the production
    sharding config and a shape-only mesh, as the reference's run.  On a
    dense arch it equals ``--mesh host`` bit for bit (one intra-op thread:
    the CPU backward is bit-reproducible only so).  At a moe SMOKE arch
    with ``moe_local_dispatch`` (and capacity factor 0.01) every moe call
    over a multiple of
    ``dp_extent`` tokens routes in ``dp_extent`` shards, each with its own
    ranks and capacity (the reference's rule); ``--mesh host`` routes in
    one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    if arch == "mixtral_8x7b":
        # capacity_factor 0.01: a shard's 16 learner tokens get the floor
        # capacity 8, so tokens drop; one shard's 256 get 128
        cfg = dataclasses.replace(train.get_config(arch, smoke=True), moe_local_dispatch=True,
                                  capacity_factor=0.01)
        monkeypatch.setattr(train, "get_config", lambda a, smoke=False: cfg)
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--seq", "64", "--n-envs", "4",
            "--batch", "4", "--steps", "2", "--ckpt-every", "0"]
    try:
        runs = {}
        for m in ("host", mesh):
            with moe.recording() as rec:
                runs[m] = train.main(args + ["--mesh", m, "--ckpt-dir", str(tmp_path / m)])
            runs[m]["records"] = list(rec)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert f"mesh={mesh}" in out
    res = runs[mesh]
    assert res["mesh"].axis_sizes == ((2, 16, 16) if mesh == "2x16x16" else (16, 16))
    assert not res["mesh"].groups and res["shd"].enabled
    assert res["shd"].dp_extent == (32 if mesh == "2x16x16" else 16)
    host, sharded = (state_tensors(runs[m]["state"]) for m in ("host", mesh))
    if arch != "mixtral_8x7b":
        for k, t in host.items():
            assert torch.equal(t, sharded[k]), k
        assert [h["loss"] for h in runs["host"]["history"]] == [
            h["loss"] for h in res["history"]]
        return
    shards = {m: [r["shards"] for r in runs[m]["records"]] for m in runs}
    assert set(shards["host"]) == {1}
    assert 16 in shards[mesh]
    # per-shard capacities drop other tokens than one shard's, and some
    drops = {m: sum(int((~r["keep"]).sum()) for r in runs[m]["records"]) for m in runs}
    assert drops[mesh] > 0 and drops[mesh] != drops["host"]
    for r in res["records"]:
        want = 16 if r["tokens"] % 16 == 0 else 1
        assert r["shards"] == want
        assert r["capacity"] == moe.capacity(cfg, r["tokens"] // want)
        keep = local_dispatch_keep(r["expert_id"].numpy(), r["shards"], r["capacity"])
        np.testing.assert_array_equal(r["keep"].numpy(), keep)


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
