"""Chaos drill: the replay-service gang through a hard server kill and a
snapshot restore, with machine-readable evidence — the port's
counterpart of the reference's ``tools/chaos_drill.py``.

    PYTHONPATH=src python -m repro_torch.launch.chaos_drill --out out/CHAOS_drill.json
    python tools/chaos_drill_torch.py --device cpu --out out/CHAOS_drill.json

Launches the real replay-service gang (``launch/multiprocess.py``) with a
hard fault plan: the server ``os._exit``s at its Nth append while every
append snapshots durably; actors and the learner park in reconnect
backoff; a replacement server restores the snapshot onto the same port
and training runs through the fault.  The drill then holds the fabric's
contracts (DESIGN.md §14), in ``check_drill``, rather than just "it
exited 0":

  * the replacement really restored (RESTORED_STEP ≥ 1, SNAPSHOTS ≥ 1);
  * exactly-once appends as identical counters — every actor's
    client-side acked-append count equals the restored server's
    per-writer applied count;
  * every actor reconnected at least once (the fault was real);
  * the server deduplicated no more appends than the clients saw deduped;
  * the limiter band held across the crash (one continuous history), and
    the learner finished all its steps.

The report it writes holds every worker's counters and the wall time.
Every role runs on the card unless ``--device cpu``.  Exit is non-zero on
any broken contract.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.launch import multiprocess as mp

# the gang shape of the service gang tests, shortened: the drill pins
# recovery invariants; the learning criterion runs in the gang test
# (learn_steps=1400 ⇒ eval return > 30)
GANG = dict(n_actors=2, samples_per_insert=8.0, batch_size=64,
            warmup=400, n_envs=8, actor_chunk=8, epsilon=0.2, seed=1)


def check_drill(res: Dict[str, Dict[str, str]], learn_steps: int) -> List[str]:
    """The broken contracts of one drill's results (``launch_service``'s
    parsed ``KEY=VALUE`` lines per role), each named; empty when all hold.
    The band is held in its exact form |samples − spi·(inserts − min)| ≤
    error_buffer: the ratio form can round an ulp past its tolerance when
    the debt ends at the band's edge."""
    server, learner = res["server"], res["learner"]
    applied = dict(kv.split(":") for kv in server["WRITER_APPENDS"].split(",") if kv)
    failures = []

    def check(ok: bool, what: str):
        if not ok:
            failures.append(what)

    check(int(server.get("RESTORED_STEP", 0)) >= 1,
          f"server did not restore (RESTORED_STEP={server.get('RESTORED_STEP')})")
    check(int(server["SNAPSHOTS"]) >= 1, "restored server never snapshot")
    for a in range(GANG["n_actors"]):
        actor = res[f"actor-{a}"]
        acked, srv = int(actor["ACKED_APPENDS"]), int(applied.get(f"actor-{a}", 0))
        check(acked == srv,
              f"actor-{a}: acked {acked} != server applied {srv} "
              f"(duplicate or lost appends across the restart)")
        check(int(actor["RECONNECTS"]) >= 1,
              f"actor-{a}: never reconnected — the fault missed it")
    deduped = sum(int(res[f"actor-{a}"]["DEDUPED_APPENDS"]) for a in range(GANG["n_actors"]))
    check(int(server["DUP_APPENDS"]) <= deduped,
          f"server deduped {server['DUP_APPENDS']} > clients saw {deduped}")
    spi, eb = float(server["CONFIGURED_SPI"]), float(server["ERROR_BUFFER"])
    debt = int(server["SAMPLES"]) - spi * (int(server["INSERTS"])
                                           - int(server["MIN_SIZE_TO_SAMPLE"]))
    check(abs(debt) <= eb,
          f"limiter band broken across restart: |samples - spi*(inserts - min)| = "
          f"{abs(debt)} > error buffer {eb} (realized spi {server['REALIZED_SPI']}, "
          f"configured {spi})")
    check(int(learner["LEARN_STEPS"]) == learn_steps,
          f"learner finished {learner['LEARN_STEPS']}/{learn_steps} steps")
    return failures


def run_drill(learn_steps: int = 300, restart_after: int = 30, out_path: Optional[str] = None,
              device: str = "cuda", timeout_s: float = 600.0) -> dict:
    """Run the gang through the server crash and return the report
    (``ok``, ``failures``, ``wall_s``, every worker's counters); write it
    as json to ``out_path`` when given.  The snapshots live in a temp dir
    removed after the run."""
    snap_dir = tempfile.mkdtemp(prefix="chaos_snap_")
    t0 = time.monotonic()
    try:
        res = mp.launch_service(learn_steps=learn_steps, timeout_s=timeout_s,
                                snapshot_dir=snap_dir, snapshot_every_appends=1,
                                restart_server_after=restart_after, retry_deadline=240.0,
                                device=device, **GANG)
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    wall_s = time.monotonic() - t0
    failures = check_drill(res, learn_steps)
    report = {
        "ok": not failures,
        "failures": failures,
        "wall_s": round(wall_s, 1),
        "learn_steps": learn_steps,
        "restart_server_after": restart_after,
        "gang": dict(GANG, device=device),
        "workers": res,
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"# wrote {out_path} (wall {wall_s:.1f}s)")
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="out/CHAOS_drill.json", help="stats json path")
    ap.add_argument("--learn-steps", type=int, default=300,
                    help="learner steps (default sized for a smoke run)")
    ap.add_argument("--restart-server-after", type=int, default=30,
                    help="hard-kill the server at this append count")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    report = run_drill(args.learn_steps, args.restart_server_after, args.out, args.device)
    for line in report["failures"]:
        print(f"CHAOS FAIL: {line}", file=sys.stderr)
    if report["ok"]:
        server = report["workers"]["server"]
        applied = sum(int(kv.split(":")[1]) for kv in server["WRITER_APPENDS"].split(",") if kv)
        print(f"chaos drill: OK — restored at step {server['RESTORED_STEP']}, "
              f"{applied} appends applied exactly once across the restart")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
