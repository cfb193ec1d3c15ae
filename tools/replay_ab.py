#!/usr/bin/env python3
"""The replay's sampling kernels in turns against their variants, on a GPU.

    python3 tools/replay_ab.py [--parent DIR]

Times, in one process for each variant and in turns (this tree, without
PDL, the parent, the parent, without PDL, this tree), the launch floor
(``torch.cuda._sleep(0)``), the descent (``ops.sumtree_sample``), the
one-leaf gather (``ops.prioritized_gather``) and ``ops.gather_items`` at
50,000/K=128/B=64 (CartPole's five leaves), 10^6/K=128/B=512 and
8,192/K=128/B=8 (the token replay's four (256,) leaves), and a learner
call's sampling chain (``chip_smoke.sampling_chain``) at the first and the
last.  The variants:

  * this tree;
  * this tree without programmatic dependent launch: a copy of
    ``src/repro_torch`` in ``build/pdl_off/`` with the gather's launch
    attribute taken out (``cfg.numAttrs = 1`` → ``0``);
  * with ``--parent``, the package under DIR (the ``src`` directory of
    another checkout, for example ``git archive`` of the parent commit
    unpacked under ``build/``); what it lacks (``gather_items``) is skipped.

Every time is ``chip_smoke.device_ms`` (the median of 60 calls behind a GPU
sleep); the chains also ``call_ms``.  Prints each process's record and the
mean of each time a variant.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GATHER = Path("repro_torch/kernels/csrc/gather.cu")
ATTR = "cfg.numAttrs = 1;"

CHILD = """
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.kernels import ops
ops.build_all()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
has_items = hasattr(ops, "gather_items")
out = {{"launch floor": cs.device_ms(torch, lambda: torch.cuda._sleep(0))}}
SHAPES = (("50,000/B=64", 50_000, 64, False), ("10^6/B=512", 1_000_000, 512, False),
          ("8,192/B=8", 8192, 8, True))
for label, cap, b, tok in SHAPES:
    spec, tree = cs.replay_tree(torch, dev, gen, cap, 128)
    storage = {{k: v for k, v in cs.replay_storage(torch, dev, gen, cap, tok).items()
               if k != "frames"}}
    u = torch.rand((b,), generator=gen, device=dev)
    idx, _ = ops.sumtree_sample(spec, tree, u)
    first = next(iter(storage.values()))
    out[label + " sumtree_sample"] = cs.device_ms(torch, lambda: ops.sumtree_sample(spec, tree, u))
    out[label + " gather, one leaf"] = cs.device_ms(torch,
                                                   lambda: ops.prioritized_gather(first, idx))
    if has_items:
        out[label + " gather_items"] = cs.device_ms(torch, lambda: ops.gather_items(storage, idx))
names = [n for n in cs.CHAIN_ARMS if has_items or "gather_items" not in n]
for label, cap, b, tok in (("50,000/B=64", 50_000, 64, False), ("8,192/B=8", 8192, 8, True)):
    chain = cs.sampling_chain(torch, dev, gen, cap, b, tok, names=names)
    for name, arm in chain["arms"].items():
        out[f"{{label}} chain: {{name}}"] = arm["device_ms"]
        out[f"{{label}} chain: {{name}} (call)"] = arm["call_ms"]
print("RECORD " + json.dumps(out))
"""


def record(src: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, "-c", CHILD.format(root=str(ROOT))], env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"replay_ab: the timing under {src} failed:\n{proc.stderr[-4000:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RECORD "))
    return json.loads(line[len("RECORD "):])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="the src directory of another checkout")
    args = ap.parse_args()
    off = ROOT / "build" / "pdl_off" / "src"
    shutil.rmtree(off.parent, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", off / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    text = (off / GATHER).read_text()
    if text.count(ATTR) != 1:
        raise SystemExit(f"replay_ab: {ATTR!r} occurs {text.count(ATTR)} times in {GATHER}")
    (off / GATHER).write_text(text.replace(ATTR, "cfg.numAttrs = 0;"))
    variants = {"this": ROOT / "src", "no PDL": off}
    if args.parent:
        variants["parent"] = args.parent.resolve()
    order = list(variants) + list(variants)[::-1]
    runs = {name: [] for name in variants}
    for name in order:
        got = record(variants[name])
        runs[name].append(got)
        print(f"[ab] {name}: {json.dumps(got)}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for key in runs["this"][0]:
        means = {name: statistics.mean(r[key] for r in rs) * 1e3
                 for name, rs in runs.items() if key in rs[0]}
        print(f"[ab] {key}: " + ", ".join(f"{name} {us:.2f} us" for name, us in means.items())
              + f" | {card}", flush=True)


if __name__ == "__main__":
    main()
