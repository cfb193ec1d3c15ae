"""The port's chaos drill (repro_torch.launch.chaos_drill, the counterpart
of the reference's ``tools/chaos_drill.py``) on the CPU: ``check_drill``
passes a well-formed result and names each broken contract of a tampered
one; one short drill runs the real gang through the server crash and the
snapshot restore, and its report must hold every contract."""

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import chaos_drill

REPO = Path(__file__).resolve().parents[1]
LEARN = 300


def _good():
    actor = {"ACKED_APPENDS": "40", "RECONNECTS": "1", "DEDUPED_APPENDS": "1"}
    return {
        "server": {"RESTORED_STEP": "31", "SNAPSHOTS": "40", "WRITER_APPENDS":
                   "actor-0:40,actor-1:40", "DUP_APPENDS": "2", "CONFIGURED_SPI": "8.0",
                   "REALIZED_SPI": "8.01", "SPI_TOLERANCE": "0.5", "ERROR_BUFFER": "8192.0",
                   "SAMPLES": "19200", "INSERTS": "2800", "MIN_SIZE_TO_SAMPLE": "400"},
        "server-0": {},
        "actor-0": dict(actor), "actor-1": dict(actor),
        "learner": {"LEARN_STEPS": str(LEARN)},
    }


def _tamper(role, key, value):
    res = _good()
    res[role][key] = value
    return res


def test_check_drill_passes_a_good_result():
    assert chaos_drill.check_drill(_good(), LEARN) == []


@pytest.mark.parametrize("res,named", [
    (_tamper("actor-1", "ACKED_APPENDS", "41"),
     "actor-1: acked 41 != server applied 40 (duplicate or lost appends across the restart)"),
    (_tamper("server", "WRITER_APPENDS", "actor-0:39,actor-1:40"),
     "actor-0: acked 40 != server applied 39"),
    (_tamper("actor-0", "RECONNECTS", "0"),
     "actor-0: never reconnected — the fault missed it"),
    (_tamper("server", "SAMPLES", "30000"), "limiter band broken across restart"),
    (_tamper("learner", "LEARN_STEPS", str(LEARN - 1)),
     f"learner finished {LEARN - 1}/{LEARN} steps"),
    (_tamper("server", "RESTORED_STEP", "0"), "server did not restore (RESTORED_STEP=0)"),
    (_tamper("server", "SNAPSHOTS", "0"), "restored server never snapshot"),
    (_tamper("server", "DUP_APPENDS", "3"), "server deduped 3 > clients saw 2"),
])
def test_check_drill_names_each_broken_contract(res, named):
    failures = chaos_drill.check_drill(res, LEARN)
    assert len(failures) == 1 and failures[0].startswith(named), failures


def test_check_drill_names_every_break_at_once():
    res = copy.deepcopy(_good())
    del res["server"]["RESTORED_STEP"]
    res["actor-0"]["RECONNECTS"] = "0"
    res["actor-1"]["ACKED_APPENDS"] = "0"
    res["learner"]["LEARN_STEPS"] = "12"
    assert len(chaos_drill.check_drill(res, LEARN)) == 4


def test_short_drill_on_the_cpu(tmp_path):
    """The real gang (a server, two actors, a learner: four processes) on
    the CPU, the server hard-killed at its 30th append, through the tool's
    entry point: exit 0, and its report holds every contract."""
    out = tmp_path / "CHAOS_drill.json"
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "chaos_drill_torch.py"),
                           "--device", "cpu", "--learn-steps", str(LEARN),
                           "--restart-server-after", "30", "--out", str(out)],
                          capture_output=True, text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads(out.read_text())
    assert report["ok"] and report["failures"] == []
    assert chaos_drill.check_drill(report["workers"], LEARN) == []
    assert report["gang"]["device"] == "cpu" and report["restart_server_after"] == 30
    server = report["workers"]["server"]
    assert server["DEVICE"] == "cpu" and int(server["RESTORED_STEP"]) >= 1
    assert "chaos drill: OK — restored at step" in proc.stdout
