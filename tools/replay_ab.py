#!/usr/bin/env python3
"""The replay's sampling kernels in turns against their variants, on a GPU.

    python3 tools/replay_ab.py [--parent DIR]

Times, in one process for each variant and in turns (this tree, without
PDL, the parent, the parent, without PDL, this tree), the launch floor
(``torch.cuda._sleep(0)``), the descent (``ops.sumtree_sample``), the
one-leaf gather (``ops.prioritized_gather``), ``ops.gather_items``, the
fused kernel (``ops.sumtree_sample_gather``), the update kernel
(``sumtree_update_cuda``, given the last-writer mask where the variant's
kernel takes one) and the replay's update call (``ops.sumtree_update``,
the mask included) at 50,000/K=128/B=64 (CartPole's five leaves),
10^6/K=128/B=512 and 8,192/K=128/B=8 (the token replay's four (256,)
leaves), and a learner call's sampling chain
(``chip_smoke.sampling_chain``) at the first and the last.  Then 100
iterations of the fused and the eager CartPole arms
(``chip_smoke.run_arm``) and ``chip_smoke.profile_loop``'s window of 20
more: wall, device-busy and device ops per iteration.  The variants:

  * this tree;
  * this tree without programmatic dependent launch: a copy of
    ``src/repro_torch`` in ``build/ab/no_PDL/`` with the gather's launch
    attribute taken out (``cfg.numAttrs = 1`` → ``0``);
  * with ``--parent``, the package under DIR (the ``src`` directory of
    another checkout, for example ``git archive`` of the parent commit
    unpacked under ``build/``); what it lacks (``gather_items``) is skipped.

With ``--update-instances`` it times instead only the update kernel
(``sumtree_update_cuda``) at the three shapes and at 10^6/K=128/B=1,024,
in three turns, against copies in ``build/ab/`` whose launcher always
takes one of its other instances: 64-bit sort keys, a division by K, or
both (this tree takes 32-bit keys and a shift at every one of these
shapes).

Every time is ``chip_smoke.device_ms`` (the median of 60 calls behind a GPU
sleep); the chains also ``call_ms``.  Prints each process's record and the
mean of each time a variant, with its smallest and largest.
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
CSRC = Path("repro_torch/kernels/csrc")
# variant → its edits of this tree's sources: (file in csrc, text, replacement)
NO_PDL = {"no PDL": (("gather.cu", "cfg.numAttrs = 1;", "cfg.numAttrs = 0;"),)}
KEYS64 = ("sumtree_update.cu", "const bool narrow = ", "const bool narrow = false && ")
DIVIDE = ("sumtree_update.cu", "const bool pow2 = ", "const bool pow2 = false && ")
INSTANCES = {"64-bit keys": (KEYS64,), "division": (DIVIDE,),
             "64-bit keys, division": (KEYS64, DIVIDE)}

CHILD = """
import inspect, json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.core import sumtree
from repro_torch.kernels import ops
from repro_torch.kernels import sumtree_update as ku
ops.build_all()
masked = "mask" in inspect.signature(ku.sumtree_update_cuda).parameters
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
    out[label + " sample_gather"] = cs.device_ms(
        torch, lambda: ops.sumtree_sample_gather(spec, tree, u, storage))
    upd_idx = torch.randint(0, cap, (b,), generator=gen, device=dev)
    upd_val = torch.rand((b,), generator=gen, device=dev)
    upd_tree = tree.clone()
    extra = (sumtree.last_writer_mask(upd_idx, spec.num_leaves),) if masked else ()
    out[label + " sumtree_update kernel"] = cs.device_ms(
        torch, lambda: ku.sumtree_update_cuda(spec, upd_tree, upd_idx, upd_val, *extra))
    out[label + " sumtree_update wrapper"] = cs.device_ms(
        torch, lambda: ops.sumtree_update(spec, upd_tree, upd_idx, upd_val))
names = [n for n in cs.CHAIN_ARMS if has_items or "gather_items" not in n]
for label, cap, b, tok in (("50,000/B=64", 50_000, 64, False), ("8,192/B=8", 8192, 8, True)):
    chain = cs.sampling_chain(torch, dev, gen, cap, b, tok, names=names)
    for name, arm in chain["arms"].items():
        out[f"{{label}} chain: {{name}}"] = arm["device_ms"]
        out[f"{{label}} chain: {{name}} (call)"] = arm["call_ms"]
for arm, fused, lazy in (("fused", True, True), ("eager", False, False)):
    ex, st, _, _, _, _ = cs.run_arm(torch, 100, fused=fused, lazy=lazy)
    _, prof = cs.profile_loop(torch, ex, st)
    for key in ("wall_us_per_iteration", "device_busy_us_per_iteration",
                "device_ops_per_iteration"):
        if prof[key] is not None:
            out[f"{{arm}} arm {{key}}"] = prof[key]
print("RECORD " + json.dumps(out))
"""

INSTANCE_CHILD = """
import json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels import sumtree_update as ku
_build.KERNELS = (ku.NAME,)   # the copies differ only in this kernel
_build.build_all()
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
out = {{"launch floor": cs.device_ms(torch, lambda: torch.cuda._sleep(0))}}
for label, cap, b in (("50,000/B=64", 50_000, 64), ("10^6/B=512", 1_000_000, 512),
                      ("8,192/B=8", 8192, 8), ("10^6/B=1,024", 1_000_000, 1024)):
    spec, tree = cs.replay_tree(torch, dev, gen, cap, 128)
    idx = torch.randint(0, cap, (b,), generator=gen, device=dev)
    val = torch.rand((b,), generator=gen, device=dev)
    out[label + " sumtree_update kernel"] = cs.device_ms(
        torch, lambda: ku.sumtree_update_cuda(spec, tree, idx, val))
print("RECORD " + json.dumps(out))
"""


def variant(name: str, edits) -> Path:
    """A copy of this tree's package under build/ab/ with ``edits`` made."""
    dst = ROOT / "build" / "ab" / name.replace(" ", "_").replace(",", "") / "src"
    shutil.rmtree(dst.parent, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for src, old, new in edits:
        path = dst / CSRC / src
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"replay_ab: {old!r} occurs {text.count(old)} times in {src}")
        path.write_text(text.replace(old, new))
    return dst


def record(src: Path, child: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, "-c", child.format(root=str(ROOT))], env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"replay_ab: the timing under {src} failed:\n{proc.stderr[-4000:]}")
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RECORD "))
    return json.loads(line[len("RECORD "):])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, help="the src directory of another checkout")
    ap.add_argument("--update-instances", action="store_true",
                    help="time the update kernel's instances instead")
    args = ap.parse_args()
    if args.update_instances and args.parent:
        ap.error("--update-instances compares copies of this tree only")
    edits = INSTANCES if args.update_instances else NO_PDL
    variants = {"this": ROOT / "src", **{n: variant(n, e) for n, e in edits.items()}}
    if args.parent:
        variants["parent"] = args.parent.resolve()
    child = INSTANCE_CHILD if args.update_instances else CHILD
    order = list(variants) + list(variants)[::-1]
    if args.update_instances:
        order += list(variants)
    runs = {name: [] for name in variants}
    for name in order:
        got = record(variants[name], child)
        runs[name].append(got)
        print(f"[ab] {name}: {json.dumps(got)}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for key in runs["this"][0]:
        # kernel times are ms (printed in us); the arms' figures are us and ops
        scale, unit = (1, "") if " arm " in key else (1e3, " us")
        got = {name: [r[key] * scale for r in rs] for name, rs in runs.items() if key in rs[0]}
        print(f"[ab] {key}: " + ", ".join(
            f"{name} {statistics.mean(xs):.2f}{unit} ({min(xs):.2f}-{max(xs):.2f})"
            for name, xs in got.items()) + f" | {card}", flush=True)


if __name__ == "__main__":
    main()
