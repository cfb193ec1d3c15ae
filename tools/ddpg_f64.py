#!/usr/bin/env python3
"""Phase 17's DDPG learn step at 200 Pendulum iterations, on the card, on
the CPU in f32 and on the CPU in f64 (ROADMAP Queue 3 item 17).

    python3 tools/ddpg_f64.py [--iterations 200] [--agent ddpg]

Runs ``chip_smoke.actor_critic_run`` (TF32 off, as its rank sets it) and
prints its ``[actor-critic f64]`` line: each side's largest distance from
the f64 step over the loss, |TD| and the state, and every |TD| element
outside the gate as (card, CPU, f64).  The run's own gate may fail at 200
iterations; the line is printed before it, and the script then exits 0
with the gate's verdict.  Needs one card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--agent", default="ddpg", choices=("ddpg", "td3", "sac"))
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        sys.exit("tools/ddpg_f64.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip() or f"nvidia-smi rc {smi.returncode}"
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    try:
        cs.actor_critic_run(torch, torch.device("cuda", 0), card, args.agent, args.iterations)
        print("gate: pass", flush=True)
    except SystemExit as e:
        print(f"gate: fail (exit {e.code})", flush=True)


if __name__ == "__main__":
    main()
