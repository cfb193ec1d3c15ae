"""``python -m repro_torch.dse_autotune`` (the port's counterpart of the
reference's ``examples/dse_autotune.py``) on the CPU, its lane curves
stubbed: the Eq. 5 lines against ``repro.runtime.planner.solve_lanes`` on
the same curves, and ``--bench-json`` against the reference's
``plan_from_json`` on a temp dir of hand-written points in the BENCH
envelope (both exact: pure Python over the same floats)."""

import dataclasses
import json

import pytest
import torch

from repro.runtime import planner as ref
from repro_torch import dse_autotune
from repro_torch.runtime import sweeps

ACTOR = {1: 950.0, 2: 1800.0, 4: 3300.0, 8: 5200.0}
LEARNER = {1: 410.0, 2: 790.0, 4: 1450.0, 8: 2300.0}


@pytest.fixture
def stub_curves(monkeypatch):
    calls = []

    def actor(x, device):
        calls.append(("actor", x, device))
        return ACTOR[x]

    def learner(x, device):
        calls.append(("learner", x, device))
        return LEARNER[x]

    monkeypatch.setattr(sweeps, "actor_throughput", actor)
    monkeypatch.setattr(sweeps, "learner_throughput", learner)
    return calls


@pytest.mark.parametrize("total,ratio", [(8, 1.0), (6, 4.0), (8, 0.5)])
def test_eq5_lines_match_reference(stub_curves, capsys, total, ratio):
    res, pc = dse_autotune.main(["--total", str(total), "--ratio", str(ratio),
                                 "--device", "cpu"])
    want = ref.solve_lanes(ACTOR, LEARNER, total, ratio)
    assert dataclasses.asdict(res) == dataclasses.asdict(want) and pc is None
    out = capsys.readouterr().out
    assert f"Eq.5 solution for total={total}, update_interval={ratio}:" in out
    assert (f"  actors x_a={want.x_actor} (→ {want.actor_throughput:,.0f}/s), "
            f"learners x_l={want.x_learner} (→ {want.learner_throughput:,.0f}/s)") in out
    assert f"  realized ratio {want.ratio:.2f} (target {want.target_ratio})" in out
    for x in (1, 2, 4, 8):
        assert f"  x={x}: f_a={ACTOR[x]:,.0f} steps/s   f_l={LEARNER[x]:,.0f} items/s" in out
    assert stub_curves == ([("actor", x, "cpu") for x in (1, 2, 4, 8)]
                           + [("learner", x, "cpu") for x in (1, 2, 4, 8)])


def _write_bench(tmp_path):
    fig9 = [{"backend": "fused", "shards": 0, "pods": 1, "publish_interval": 0,
             "max_staleness": 0, "n_envs": 8, "env_steps_per_s": 310.5,
             "speedup_vs_sync": 1.0, "repeats": 3, "rel_spread": 0.02},
            {"backend": "async", "shards": 0, "pods": 1, "publish_interval": 2,
             "max_staleness": 0, "n_envs": 8, "env_steps_per_s": 355.25,
             "speedup_vs_sync": 1.144, "repeats": 3, "rel_spread": 0.03}]
    fig10 = [{"backend": "sharded", "shards": 2, "pods": 1, "compressed": False,
              "n_envs": 8, "env_steps_per_s": 201.0, "repeats": 3, "rel_spread": 0.05}]
    for figure, points in (("fig9", fig9), ("fig10", fig10)):
        (tmp_path / f"BENCH_{figure}.json").write_text(json.dumps(
            {"figure": figure, "metric": "env_steps_per_s", "points": points}))


@pytest.mark.parametrize("ratio", [1.0, 1.6])
def test_bench_json_writes_the_reference_plan(stub_curves, capsys, tmp_path, ratio):
    _write_bench(tmp_path)
    _, pc = dse_autotune.main(["--bench-json", str(tmp_path), "--ratio", str(ratio),
                               "--device", "cpu"])
    ui = max(1, round(ratio))
    want = ref.plan_from_json(str(tmp_path), actor_curve=ACTOR, learner_curve=LEARNER,
                              total_lanes=8, update_interval=ui)
    assert pc.to_dict() == want.to_dict()
    plan_path = tmp_path / "BENCH_plan.json"
    ref_path = tmp_path / "ref_plan.json"
    ref.save_plan(want, str(ref_path))
    assert plan_path.read_text() == ref_path.read_text()
    out = capsys.readouterr().out
    assert (f"note: --ratio {ratio:g} rounded to update_interval={ui}" in out) == (ui != ratio)
    assert f"planner-selected config: {pc.describe()}" in out
    assert (f"  run it:  PYTHONPATH=src python -m repro_torch.quickstart --plan {plan_path} "
            "--device cpu") in out


def test_refuses_without_gpu(monkeypatch, stub_curves):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        dse_autotune.main(["--total", "8"])
    assert not stub_curves
