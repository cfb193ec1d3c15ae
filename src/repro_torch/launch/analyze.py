"""Per-op profile of a dry-run cell — port of ``repro.launch.analyze``: the
top ops by bytes a device and the top collectives by wire bytes a device
(each extrapolated to the full step, ``launch/dryrun.py``), and the bytes
by op kind, as the reference's ``op_profile`` prints them from its HLO.

    PYTHONPATH=src python -m repro_torch.launch.analyze --arch qwen1_5_32b --shape train_4k
"""

from __future__ import annotations

import argparse
import collections
from typing import List, Optional

from repro_torch.launch import roofline as RL
from repro_torch.launch.dryrun import Tally


def op_profile(tally: Tally, top: int = 25) -> None:
    byte_rows = sorted(((nbytes, f"{op}×{calls:g}", shapes)
                        for (op, shapes), (calls, nbytes) in tally.ops.items()), reverse=True)
    coll_rows = sorted(((RL.wire_bytes(op, nbytes, n) * calls, f"{op}(g={n})×{calls:g}",
                         f"{nbytes / 1e6:.6g} MB out")
                        for (op, n, nbytes), calls in tally.colls.items()), reverse=True)
    total_b = sum(r[0] for r in byte_rows)
    total_c = sum(r[0] for r in coll_rows)
    print(f"\n== bytes/device (unfused): {total_b/1e9:.1f} GB "
          f"(t_mem={total_b/RL.HBM_BW:.2f}s) — top {top} ops ==")
    for b, op, label in byte_rows[:top]:
        print(f"  {b/1e9:9.2f} GB  {op:<36} {label}")
    print(f"\n== collective wire bytes/device: {total_c/1e9:.1f} GB "
          f"(t_coll={total_c/RL.LINK_BW:.2f}s) — top {top} ==")
    for b, op, label in coll_rows[:top]:
        print(f"  {b/1e9:9.2f} GB  {op:<32} {label}")

    # aggregate by op kind
    agg: collections.Counter = collections.Counter()
    for b, op, _ in byte_rows:
        agg[op.split("×")[0]] += b
    print("\n== bytes by op kind ==")
    for k, v in agg.most_common(12):
        print(f"  {v/1e9:9.2f} GB  {k}")


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", action="store_true")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    from repro_torch.launch.dryrun import build_cell

    run, info = build_cell(args.arch, args.shape, args.multi_pod, opt=args.opt)
    print("cell info:", {k: v for k, v in info.items() if k != "skipped"})
    if run is None:
        return
    op_profile(run(), args.top)


if __name__ == "__main__":
    main()
