"""The dry run's sweep as a markdown table: one row a (config, mesh), one
column a shape, each cell its three roofline terms in seconds (compute /
memory / collective) and the dominant one's initial, and the state's bytes a
device of the train cell.  The records are ``launch/dryrun.py``'s JSON
files.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out DIR
    python tools/dryrun_table.py DIR
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ARCHS = ("qwen1_5_32b", "granite_8b", "internlm2_1_8b", "command_r_35b", "mixtral_8x7b",
         "llama4_maverick_400b_a17b", "hymba_1_5b", "whisper_medium", "xlstm_125m",
         "phi_3_vision_4_2b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def cell(rec) -> str:
    if rec is None:
        return "not run"
    if rec["status"] != "ok":
        return rec["status"] if rec["status"] == "skipped" else f"**{rec['status']}**"
    return (f"{rec['t_compute']:.3g} / {rec['t_memory']:.3g} / {rec['t_collective']:.3g} "
            f"{rec['dominant'][0]}")


def main(out_dir: str) -> None:
    recs = {}
    for path in Path(out_dir).glob("*.json"):
        rec = json.loads(path.read_text())
        recs[(rec["arch"], rec["shape"], rec["multi_pod"])] = rec
    print("| config | mesh | train GB a device | " + " | ".join(SHAPES) + " | slowest cell s |")
    print("| --- | --- | --- |" + " --- |" * (len(SHAPES) + 1))
    for arch in ARCHS:
        for mp in (False, True):
            row = [recs.get((arch, shape, mp)) for shape in SHAPES]
            train = row[0]
            gb = (f"{train['state_bytes_per_device'] / 1e9:.3g}"
                  if train and train.get("status") == "ok" else "—")
            slowest = max((r.get("total_s", 0.0) for r in row if r), default=0.0)
            print(f"| {arch} | {'2×16×16' if mp else '16×16'} | {gb} | "
                  + " | ".join(cell(r) for r in row) + f" | {slowest} |")


if __name__ == "__main__":
    main(sys.argv[1])
