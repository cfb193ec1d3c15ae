"""The port's ratio-scheduled token-DQN trainer
(``python -m repro_torch.train_token_dqn``) on the CPU, against the
reference's ``examples/train_token_dqn.py`` where the two can be held to
each other: its model config, the ``RatioSchedule`` it prints (equal to
``repro.runtime.loop.RatioSchedule.from_config`` for every tested
update interval and learns per step), the learn events that schedule
gives, finite losses, and a resume from its own checkpoint.  The run is
``--small`` with few actors and short segments; the collect and learn
themselves are held to the reference in ``test_torch_token_dqn.py``.
"""

import dataclasses
import re

import pytest
import torch

from repro.runtime.loop import LoopConfig as JLoopConfig
from repro.runtime.loop import RatioSchedule as JRatioSchedule
from repro_torch import train_token_dqn as ttd
from repro_torch.agents.base import state_tensors
from repro_torch.checkpoint.manager import CheckpointManager

torch.set_num_threads(2)

SCHEDULE_LINE = re.compile(r"ratio schedule: learn every (\d+) collect\(s\), (\d+) update\(s\) "
                           r"per event \((\d+) segments per update\)")
SMALL = ["--small", "--device", "cpu", "--n-envs", "32", "--seq", "16", "--batch", "4"]


def _reference_example_config():
    """The reference example's ``CFG_100M``, read from its source (it
    imports nothing that the test could not: the module runs ``main``
    only as a script)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "train_token_dqn.py"
    spec = importlib.util.spec_from_file_location("ref_train_token_dqn", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CFG_100M


def test_model_config_is_the_reference_examples():
    ref = _reference_example_config()
    assert dataclasses.asdict(ttd.CFG_100M) == dataclasses.asdict(ref)
    small = ttd.model_config(True)
    assert (small.num_layers, small.d_model, small.num_heads, small.num_kv_heads,
            small.d_ff, small.vocab_size) == (2, 64, 4, 2, 128, 256)


@pytest.mark.parametrize("learns_per_step", [1, 2])
@pytest.mark.parametrize("interval", [16, 32, 64, 128])
def test_printed_schedule_matches_reference(interval, learns_per_step, tmp_path, capsys):
    out = ttd.main(SMALL + ["--steps", "0", "--update-interval", str(interval),
                            "--learns-per-step", str(learns_per_step),
                            "--ckpt-dir", str(tmp_path)])
    ref = JRatioSchedule.from_config(
        JLoopConfig(update_interval=interval, learns_per_step=learns_per_step),
        env_steps_per_iter=32)
    sched = out["schedule"]
    assert (sched.period, sched.learns, sched.env_steps_per_iter) == \
        (ref.period, ref.learns, ref.env_steps_per_iter)
    printed = SCHEDULE_LINE.search(capsys.readouterr().out)
    assert printed is not None
    assert printed.groups() == (str(ref.period), str(ref.learns),
                                f"{ref.realized_ratio:.0f}")
    assert out["learns"] == [] and out["checkpoints"] == [0]


def test_learns_on_schedule_and_resumes(tmp_path, capsys):
    argv = SMALL + ["--update-interval", "64", "--ckpt-every", "4", "--ckpt-dir",
                    str(tmp_path), "--seed", "1"]
    out = ttd.main(argv + ["--steps", "8"])
    # period 2, one update an event: learns at collects 0, 2, 4, 6
    assert (out["schedule"].period, out["schedule"].learns) == (2, 1)
    assert [e["it"] for e in out["learns"]] == [0, 2, 4, 6]
    assert all(torch.isfinite(torch.tensor(e[k])) for e in out["learns"]
               for k in ("loss", "grad_norm", "q_mean"))
    assert out["start"] is None and int(out["state"].step) == 4
    assert out["checkpoints"] == [4, 8]
    assert out["replay_state"].count == 8 * 32
    # eager writes, as the reference's: an insert is two updates (zero the
    # slots, then their priority), a priority write-back one; a learn call
    # samples once and gathers the four storage leaves
    counts = out["replay"].ops.counts
    assert (counts["update"], counts["sample"], counts["gather"]) == (2 * 8 + 4, 4, 4 * 4)
    assert not counts["flush"] and not counts["write_leaves"]
    saved = state_tensors(out["state"])
    restored = CheckpointManager(str(tmp_path)).restore(8, {
        k: torch.empty_like(t) for k, t in saved.items()})
    assert all(torch.equal(restored[k], saved[k]) for k in saved)
    capsys.readouterr()
    again = ttd.main(argv + ["--steps", "10"])
    printed = capsys.readouterr().out
    assert "resumed from checkpoint step 8" in printed and again["start"] == 8
    # the resumed run starts from the saved learner state: one learn event
    # (collect 8) on top of its 4 updates
    assert [e["it"] for e in again["learns"]] == [8] and int(again["state"].step) == 5
    assert again["checkpoints"] == [8, 10]
    assert again["replay_state"].count == 2 * 32


def test_needs_cuda_unless_cpu_requested(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttd.main(["--small", "--steps", "1", "--ckpt-dir", str(tmp_path)])
