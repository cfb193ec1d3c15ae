#!/usr/bin/env python3
"""The backward pair that f32 and hd 16 take (#6b dQ, #7b dK/dV), timed in
turns against another checkout's, on a GPU.

    python3 tools/flash_bwd_ab.py [--parent DIR] [--check] [--out FILE]

Times, in one process for each variant and in turns (this tree, each
other variant, the same in reverse, this tree; this tree alone without
``--parent`` or ``--variants``),
``chip_smoke.f32_pair_times`` at (128, 256, 128) f32, the wall-clock
trainer's (32, 128, 16) f32 and (128, 256, 128) bf16, all causal: each
kernel's device time (``chip_smoke.device_ms``, the median of 30 calls
behind a GPU sleep) and call time, its plain version, one SDPA backward
call on the same inputs and the bound (3xTF32's rate for f32 with the FMA
rate's beside it; the bf16 rate for bf16).  ``--parent`` is the ``src``
directory of another checkout, for example ``git archive`` of the parent
commit unpacked under ``build/``; ``--variants`` names copies of this
tree's package in ``build/ab/<name>/`` with one design choice of
``VARIANTS`` undone, which take their turns beside it.  With ``--check``, this tree's process
first holds the pair to the plain backward on phase 11's cases that go to
it (``chip_smoke.pair_parity``) and prints ptxas's registers and spills
of both kernels and the count of tensor-core (HMMA) and asynchronous-copy
(LDGSTS) instructions in their SASS.  Prints each process's record, then
each time's mean over the turns a variant, with its smallest and largest;
``--out`` also writes the records as JSON.
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
# variant → its edits of this tree's sources: (file in csrc, text, replacement);
# each undoes one design choice, or (timing only, wrong results) takes a
# part of the work away
VARIANTS = {
    # TF32 rounding on the conversion unit instead of two integer operations
    "cvt": (("flash_mma.cuh", "return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
             'uint32_t r;\n    asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
             "    return r;"),),
    # timing only: one TF32 product instead of three
    "1xTF32": (("flash_mma.cuh",
                "        mma_tf32(d, a.small, b.big);\n        mma_tf32(d, a.big, b.small);\n", ""),),
    # timing only: no split of f32 operands (big = x, small = 0)
    "no split ALU": (("flash_mma.cuh", "big = tf32(x);\n    small = tf32(x - __uint_as_float(big));",
                      "big = __float_as_uint(x);\n    small = 0u;"),),
    # timing only: dK/dV without its second product, or without its first
    "dkv no second product": (
        ("flash_attention_dkv.cu",
         "M::mma(&acc[4 * c], a, M::load_b_kn(b_second + j * 8 * LD + c * 8, LD, lane));",
         "acc[4 * c] += x[4 * j];"),),
    "dkv no first product": (
        ("flash_attention_dkv.cu",
         "M::mma(&x[4 * j], a, M::load_b_nk(b_first + j * 8 * LD + d0, LD, lane));",
         "x[4 * j] += (float)d0;"),),
    # one warp (dQ) or pair (dK/dV) a row block: no split of a tile's keys (queries)
    "no split": (
        ("flash_attention_dq.cu", "SPLIT = sizeof(T) == 4 ? 4 : 2;", "SPLIT = 1;"),
        ("flash_attention_dkv.cu", "SPLIT = HD <= 32 ? 4 : 2;", "SPLIT = 1;")),
    # two dQ warps a row block in f32 too
    "dq split 2": (("flash_attention_dq.cu", "SPLIT = sizeof(T) == 4 ? 4 : 2;", "SPLIT = 2;"),),
    # 64-row dQ CTAs with 64-key tiles at hd 64-128 (one CTA an SM at hd 128 in f32)
    "dq 64 rows": (
        ("flash_attention_dq.cu", "ROW_WARPS = 2;", "ROW_WARPS = HD <= 32 ? 2 : 4;"),
        ("flash_attention_dq.cu", "BK = 32;", "BK = 64;"),
        ("flash_attention_dq.cu", "SPLIT = sizeof(T) == 4 ? 4 : 2;", "SPLIT = 4;")),
    # exp2 with exp2f's range handling instead of ex2.approx.ftz
    "exp2f": (("flash_attention_dq.cu", "flash::exp2_approx(", "exp2f("),
              ("flash_attention_dkv.cu", "flash::exp2_approx(", "exp2f(")),
    # 64-key dK/dV CTAs at hd 64-128 (one CTA an SM at hd 128 in f32)
    "dkv 64 keys": (("flash_attention_dkv.cu", "KEY_WARPS = 2;", "KEY_WARPS = HD <= 32 ? 2 : 4;"),),
    # query tiles of 64 at hd 96 and 128 too
    "dkv BQ 64": (("flash_attention_dkv.cu", "BQ = HD >= 96 ? 32 : 64;", "BQ = 64;"),),
}
SHAPES = (("(128, 256, 128) f32", 128, 256, 128, "float32"),
          ("(32, 128, 16) f32", 32, 128, 16, "float32"),
          ("(128, 256, 128) bf16", 128, 256, 128, "bfloat16"))

CHILD = """
import json, subprocess, sys, torch
from pathlib import Path
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.kernels import _build, ops
torch.backends.cuda.matmul.allow_tf32 = False
ops.build_all()
dev = torch.device("cuda", 0)
out = {{}}
if {check!r}:
    out["parity"] = cs.pair_parity(torch, dev)
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    for name in ("flash_attention_dq", "flash_attention_dkv"):
        sass = subprocess.run([cuobjdump, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, timeout=300).stdout
        out[name] = {{"ptxas": [l.strip() for l in _build.build_log(name).splitlines()
                               if "registers" in l or "spill" in l],
                     "HMMA": sass.count("HMMA"), "LDGSTS": sass.count("LDGSTS")}}
for label, n, s, hd, dt in {shapes!r}:
    out[label] = cs.f32_pair_times(torch, dev, n, s, hd, getattr(torch, dt))
print("RECORD " + json.dumps(out))
"""


def run(src: Path, check: bool) -> dict:
    code = CHILD.format(root=str(ROOT), check=check, shapes=SHAPES)
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"variant {src} failed (rc {proc.returncode}):\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RECORD ")][-1]
    return json.loads(line[len("RECORD "):])


def variant_src(name: str) -> Path:
    """A copy of this tree's package in build/ab/<name>/src with the
    variant's edits."""
    src = ROOT / "build" / "ab" / name.replace(" ", "_") / "src"
    shutil.rmtree(src.parent, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in VARIANTS[name]:
        path = src / CSRC / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs {text.count(old)} times in {fname}")
        path.write_text(text.replace(old, new))
    return src


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="src directory of another checkout")
    ap.add_argument("--variants", default="",
                    help=f"comma-separated names of {tuple(VARIANTS)}")
    ap.add_argument("--check", action="store_true",
                    help="hold this tree's pair to the plain backward first")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[card] {smi.stdout.strip()}", flush=True)
    here = ROOT / "src"
    others = [(name, variant_src(name)) for name in filter(None, args.variants.split(","))]
    if args.parent is not None:
        others.append(("parent", args.parent.resolve()))
    turns = [("this tree", here), *others, *others[::-1], ("this tree", here)] if others \
        else [("this tree", here)]
    records = []
    for i, (label, src) in enumerate(turns):
        rec = run(src, check=args.check and i == 0)
        records.append({"variant": label, **rec})
        print(f"[record] {label}: {json.dumps(rec)}", flush=True)
    for label in dict.fromkeys(v for v, _ in turns):
        mine = [r for r in records if r["variant"] == label]
        for shape, *_ in SHAPES:
            for name in mine[0][shape]:
                for key in ("ms", "call_ms", "plain_ms", "library_ms"):
                    xs = [r[shape][name][key] * 1e3 for r in mine]
                    print(f"[mean] {label} {name} {shape} {key}: "
                          f"{statistics.mean(xs):.2f} us (min {min(xs):.2f}, max {max(xs):.2f}, "
                          f"{len(xs)} turns)", flush=True)
                t = mine[0][shape][name]
                fma = (f", at the FMA rate {t['bound_fma_ms'] * 1e3:.2f} us by "
                       f"{t['bound_fma_by']}" if "bound_fma_ms" in t else "")
                print(f"[bound] {name} {shape}: {t['bound_ms'] * 1e3:.3f} us by "
                      f"{t['bound_by']}{fma}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi.stdout.strip(), "records": records},
                                       indent=1))


if __name__ == "__main__":
    main()
