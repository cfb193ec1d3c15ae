"""DSE auto-tuning (paper §V-D): profile collection/consumption curves on
this machine and print the Eq. 5 actor/learner allocation — and, when a
BENCH json directory is given, the full planner-selected runtime config
(runtime/planner.py, DESIGN.md §8).  The port's counterpart of the
reference's ``examples/dse_autotune.py``; the curves are
``runtime/sweeps.py``'s, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.dse_autotune --total 8 --ratio 1

    # full-config planning from measured BENCH json in DIR
    PYTHONPATH=src python -m repro_torch.dse_autotune --bench-json DIR
"""

import argparse
import os

from repro_torch.device import resolve_device
from repro_torch.runtime import dse, planner, sweeps

LANES = [1, 2, 4, 8]


def main(argv=None):
    """Returns (the Eq. 5 solution, the planned config or None)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--total", type=int, default=8)
    ap.add_argument("--ratio", type=float, default=1.0,
                    help="update_interval (collect/consume target)")
    ap.add_argument("--bench-json", default=None, metavar="DIR",
                    help="also plan the full runtime config from the "
                         "BENCH json in DIR (fig9/fig10 points)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)           # no GPU and no --device cpu: raise here

    print("profiling actor curve f_a(x)...")
    fa = dse.profile_curve(lambda x: sweeps.actor_throughput(x, args.device), LANES)
    print("profiling learner curve f_l(x)...")
    fl = dse.profile_curve(lambda x: sweeps.learner_throughput(x, args.device), LANES)
    for x in LANES:
        print(f"  x={x}: f_a={fa[x]:,.0f} steps/s   f_l={fl[x]:,.0f} items/s")
    res = planner.solve_lanes(fa, fl, args.total, args.ratio)
    print(f"\nEq.5 solution for total={args.total}, "
          f"update_interval={args.ratio}:")
    print(f"  actors x_a={res.x_actor} (→ {res.actor_throughput:,.0f}/s), "
          f"learners x_l={res.x_learner} (→ {res.learner_throughput:,.0f}/s)")
    print(f"  realized ratio {res.ratio:.2f} (target {res.target_ratio})")

    pc = None
    if args.bench_json:
        # executable configs carry an integer update_interval
        # (LoopConfig); round a fractional --ratio rather than silently
        # truncating it, and say so
        ui = max(1, round(args.ratio))
        if ui != args.ratio:
            print(f"\nnote: --ratio {args.ratio:g} rounded to "
                  f"update_interval={ui} for the executable plan")
        pc = planner.plan_from_json(
            args.bench_json, actor_curve=fa, learner_curve=fl,
            total_lanes=args.total, update_interval=ui)
        # write the plan just computed, so the printed command runs THIS
        # config — not whatever an earlier run left in the dir
        plan_path = os.path.join(args.bench_json, planner.PLAN_JSON)
        planner.save_plan(pc, plan_path)
        device = " --device cpu" if args.device == "cpu" else ""
        print(f"\nplanner-selected config: {pc.describe()}")
        print("  run it:  PYTHONPATH=src python -m repro_torch.quickstart "
              f"--plan {plan_path}{device}")
    return res, pc


if __name__ == "__main__":
    main()
