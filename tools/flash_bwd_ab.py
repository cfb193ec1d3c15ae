#!/usr/bin/env python3
"""The flash kernels that f32 and hd 16 take, timed in turns against
another checkout's, on a GPU: the backward pair (#6b dQ, #7b dK/dV) or,
with ``--pass fwd``, the forward (#5b).

    python3 tools/flash_bwd_ab.py [--pass bwd|fwd] [--parent DIR] [--variants A,B]
                                  [--check] [--out FILE]

Times, in one process for each variant and in turns (this tree, each
other variant, the same in reverse, this tree; this tree alone without
``--parent`` or ``--variants``), each kernel's device time
(``chip_smoke.device_ms``, the median of 30 calls behind a GPU sleep) and
call time, its plain version, one SDPA call on the same inputs and the
bound (3xTF32's rate for f32 with the FMA rate's beside it; the bf16 rate
for bf16).  The backward: ``chip_smoke.f32_pair_times`` at (128, 256, 128)
f32, the wall-clock trainer's (32, 128, 16) f32 and (128, 256, 128) bf16;
the forward: ``chip_smoke.fwd_kernel_times`` at (128, 256, 128) f32, (4,
256, 64) f32 and (32, 128, 16) in f32 and bf16 (26(c)'s route); all
causal.  ``--parent`` is the ``src`` directory of another checkout, for
example ``git archive`` of the parent commit unpacked under ``build/``;
``--variants`` names copies of this tree's package in
``build/ab/<name>/`` with one design choice of the pass's variants undone
(``VARIANTS``, ``FWD_VARIANTS``), which take their turns beside it.  With
``--check``, this tree's process first holds the kernels to their plain
version on the chip_smoke cases that go to them (``pair_parity``,
``fwd_parity``) and prints ptxas's registers and spills of each kernel
and the count of tensor-core (HMMA) and asynchronous-copy (LDGSTS)
instructions in their SASS.  Prints each process's record, then each
time's mean over the turns a variant, with its smallest and largest;
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
# the forward's: each undoes one design choice of flash_attention_fwd.cu, or
# (timing only, wrong results) takes a part of the work away
FWD_VARIANTS = {
    # one shape for every grid: 4 warps of 16 rows (WIDE), or 4 warps on the
    # same 16 rows (DEEP)
    "wide only": (("flash_attention_fwd.cu", "if (wide_warps >= 8L * sm_count())",
                   "if (wide_warps >= 0)"),),
    "deep only": (("flash_attention_fwd.cu", "if (wide_warps >= 8L * sm_count())",
                   "if (wide_warps < 0)"),),
    # 32-key WIDE tiles (101 KB of shared memory at hd 128 in f32: two CTAs an SM)
    "wide 32 keys": (("flash_attention_fwd.cu", "8 * Mma<T>::C_TILES : 16;",
                      "8 * Mma<T>::C_TILES : 32;"),
                     ("flash_attention_fwd.cu", "MIN_CTAS = DEEP ? 1 : 3;", "MIN_CTAS = 1;")),
    # no cap on the registers (three WIDE CTAs an SM fit in shared memory only)
    "no register cap": (("flash_attention_fwd.cu", "MIN_CTAS = DEEP ? 1 : 3;", "MIN_CTAS = 1;"),),
    # 8 warps of 16 rows a CTA (101 KB at hd 128 in f32), two CTAs an SM
    "8 warps": (("flash_attention_fwd.cu", "ROW_WARPS = DEEP ? 1 : 4;", "ROW_WARPS = DEEP ? 1 : 8;"),
                ("flash_attention_fwd.cu", "MIN_CTAS = DEEP ? 1 : 3;", "MIN_CTAS = DEEP ? 1 : 2;")),
    # the per-entry mask test on every tile
    "no whole tiles": (("flash_attention_fwd.cu", "const bool whole = kt * BK + BK <= Sk",
                        "const bool whole = false && kt * BK + BK <= Sk"),),
    # exp2 with exp2f's range handling instead of ex2.approx.ftz
    "exp2f": (("flash_attention_fwd.cu", "corr = flash::exp2_approx(", "corr = exp2f("),
              ("flash_attention_fwd.cu", "p = flash::exp2_approx(", "p = exp2f(")),
    # a head's query tiles next to each other in launch order (heaviest first
    # within a head only)
    "head-major grid": (("flash_attention_fwd.cu", "    const int n = blockIdx.x;\n",
                         "    const int n = blockIdx.y;\n"),
                        ("flash_attention_fwd.cu",
                         "    const int q_start = (gridDim.y - 1 - blockIdx.y) * BQ;",
                         "    const int q_start = (gridDim.x - 1 - blockIdx.x) * BQ;"),
                        ("flash_attention_fwd.cu",
                         "    const dim3 grid((unsigned)n, (unsigned)((s + Sh::BQ - 1) / Sh::BQ));",
                         "    const dim3 grid((unsigned)((s + Sh::BQ - 1) / Sh::BQ), (unsigned)n);")),
    # two K/V stages for DEEP too
    "deep 2 stages": (("flash_attention_fwd.cu", "STAGES = DEEP ? 4 : 2;", "STAGES = 2;"),),
    # the small part of a 3xTF32 split left for the tensor core to truncate
    # (one rounding instead of two)
    "trunc small": (("flash_mma.cuh", "small = tf32(x - __uint_as_float(big));",
                     "small = __float_as_uint(x - __uint_as_float(big));"),),
    # timing only: the SM cycles each warp spends in the parts of a tile,
    # summed over the warps (flash_fwd_prof)
    "prof": (("flash_attention_fwd.cu", "constexpr float LN2 = 0.6931471805599453f;\n",
              "constexpr float LN2 = 0.6931471805599453f;\n"
              "__device__ unsigned long long g_prof[5];\n"),
             ("flash_attention_fwd.cu", "    for (int it = 0; kt < nk; ++it) {\n",
              "    long long prof[5] = {};\n    for (int it = 0; kt < nk; ++it) {\n"
              "        long long c0 = clock64();\n"),
             ("flash_attention_fwd.cu",
              "        flash::cp_async_wait<STAGES - 1>(); // this tile's copies have landed\n"
              "        __syncthreads();\n",
              "        flash::cp_async_wait<STAGES - 1>(); // this tile's copies have landed\n"
              "        __syncthreads();\n        long long c1 = clock64(); prof[0] += c1 - c0;\n"),
             ("flash_attention_fwd.cu", "        // the online softmax, row by row",
              "        long long c2 = clock64(); prof[1] += c2 - c1;\n"
              "        // the online softmax, row by row"),
             ("flash_attention_fwd.cu", "        // O += P V\n",
              "        long long c3 = clock64(); prof[2] += c3 - c2;\n        // O += P V\n"),
             ("flash_attention_fwd.cu",
              "        __syncthreads();                    // this stage is read: a later copy",
              "        long long c4 = clock64(); prof[3] += c4 - c3;\n"
              "        __syncthreads();                    // this stage is read: a later copy"),
             ("flash_attention_fwd.cu", "        kt = next_tile(kt + 1);\n    }\n",
              "        kt = next_tile(kt + 1);\n        prof[4] += clock64() - c4;\n    }\n"
              "    if (lane == 0)\n        for (int i = 0; i < 5; ++i)\n"
              "            atomicAdd(&g_prof[i], (unsigned long long)prof[i]);\n"),
             ("flash_attention_fwd.cu", "extern \"C\" int flash_attention_fwd_launch(",
              "extern \"C\" int flash_fwd_prof(unsigned long long* out) {\n"
              "    cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
              "    const unsigned long long zero[5] = {};\n"
              "    return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));\n}\n\n"
              "extern \"C\" int flash_attention_fwd_launch(")),
    # timing only: one TF32 product instead of three
    "1xTF32": VARIANTS["1xTF32"],
    # timing only: no split of f32 operands (big = x, small = 0)
    "no split ALU": VARIANTS["no split ALU"],
    # timing only: no Q K^T product
    "no S": (("flash_attention_fwd.cu",
              "M::mma(&s[4 * j], a_q, M::load_b_nk(cK + j * 8 * LD + ks * M::KS, LD, lane));",
              "s[4 * j] += (float)ks;"),),
    # timing only: no exponentials (p = the score)
    "no exp": (("flash_attention_fwd.cu",
                "const float p = flash::exp2_approx(s[4 * j + e] - m_new);",
                "const float p = s[4 * j + e] - m_new;"),),
    # timing only: no P V product
    "no PV": (("flash_attention_fwd.cu",
               "M::mma(&acc[4 * c], a_p, M::load_b_kn(cV + j * 8 * LD + c * 8, LD, lane));",
               "acc[4 * c] += s[4 * j];"),),
}
SHAPES = (("(128, 256, 128) f32", 128, 256, 128, "float32"),
          ("(32, 128, 16) f32", 32, 128, 16, "float32"),
          ("(128, 256, 128) bf16", 128, 256, 128, "bfloat16"))
FWD_SHAPES = (("(128, 256, 128) f32", 128, 256, 128, "float32"),
              ("(4, 256, 64) f32", 4, 256, 64, "float32"),
              ("(32, 128, 16) f32", 32, 128, 16, "float32"),
              ("(32, 128, 16) bf16", 32, 128, 16, "bfloat16"))

CHILD = """
import json, subprocess, sys, torch
from pathlib import Path
sys.path.insert(0, {root!r})
import chip_smoke as cs
from repro_torch.kernels import _build, ops
torch.backends.cuda.matmul.allow_tf32 = False
ops.build_all()
dev = torch.device("cuda", 0)
fwd = {fwd!r}
out = {{}}
def cs_opcodes(sass):
    # each kernel instance's SASS: instructions and the most frequent opcodes
    import collections, re
    fns, cur = {{}}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = fns.setdefault(line.split("Function :")[1].strip()[-60:], collections.Counter())
        elif cur is not None:
            m = re.match(r"\\s*/\\*[0-9a-f]+\\*/\\s+(?:@!?U?P\\w+\\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                cur[m.group(1)] += 1
    return {{f: {{"total": sum(c.values()), "top": c.most_common(14)}} for f, c in fns.items()}}
if {check!r}:
    out["parity"] = cs.fwd_parity(torch, dev) if fwd else cs.pair_parity(torch, dev)
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    names = ("flash_attention_fwd",) if fwd else ("flash_attention_dq", "flash_attention_dkv")
    for name in names:
        sass = subprocess.run([cuobjdump, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True, timeout=300).stdout
        out[name] = {{"ptxas": [l.strip() for l in _build.build_log(name).splitlines()
                               if "registers" in l or "spill" in l or "entry function" in l],
                     "HMMA": sass.count("HMMA"), "LDGSTS": sass.count("LDGSTS"),
                     "opcodes": cs_opcodes(sass)}}
for label, n, s, hd, dt in {shapes!r}:
    if fwd:
        out[label] = {{"flash_attention_fwd": cs.fwd_kernel_times(torch, dev, n, s, hd,
                                                                  getattr(torch, dt))}}
    else:
        out[label] = cs.f32_pair_times(torch, dev, n, s, hd, getattr(torch, dt))
lib = _build.load("flash_attention_fwd")
if fwd and hasattr(lib, "flash_fwd_prof"):
    import ctypes
    from repro_torch.kernels import flash_attention as fa
    buf = (ctypes.c_ulonglong * 5)()
    for label, n, s, hd, dt in {shapes!r}:
        q, k, v = (torch.randn((n, s, hd), device=dev).to(getattr(torch, dt)) for _ in range(3))
        fa.flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        lib.flash_fwd_prof(buf)
        for _ in range(10):
            fa.flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        lib.flash_fwd_prof(buf)
        out.setdefault("prof", {{}})[label] = list(buf)
print("RECORD " + json.dumps(out))
"""


def run(src: Path, check: bool, fwd: bool) -> dict:
    code = CHILD.format(root=str(ROOT), check=check, fwd=fwd,
                        shapes=FWD_SHAPES if fwd else SHAPES)
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"variant {src} failed (rc {proc.returncode}):\n"
                         f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RECORD ")][-1]
    return json.loads(line[len("RECORD "):])


def variant_src(name: str, variants: dict) -> Path:
    """A copy of this tree's package in build/ab/<name>/src with the
    variant's edits."""
    src = ROOT / "build" / "ab" / name.replace(" ", "_") / "src"
    shutil.rmtree(src.parent, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in variants[name]:
        path = src / CSRC / fname
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name}: {old!r} occurs {text.count(old)} times in {fname}")
        path.write_text(text.replace(old, new))
    return src


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pass", dest="which", choices=("bwd", "fwd"), default="bwd",
                    help="the backward pair (#6b, #7b) or the forward (#5b)")
    ap.add_argument("--parent", type=Path, default=None,
                    help="src directory of another checkout")
    ap.add_argument("--variants", default="",
                    help=f"comma-separated names of {tuple(VARIANTS)} (bwd) or "
                         f"{tuple(FWD_VARIANTS)} (fwd)")
    ap.add_argument("--check", action="store_true",
                    help="hold this tree's kernels to their plain version first")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"[card] {smi.stdout.strip()}", flush=True)
    fwd = args.which == "fwd"
    variants, shapes = (FWD_VARIANTS, FWD_SHAPES) if fwd else (VARIANTS, SHAPES)
    here = ROOT / "src"
    others = [(name, variant_src(name, variants))
              for name in filter(None, args.variants.split(","))]
    if args.parent is not None:
        others.append(("parent", args.parent.resolve()))
    turns = [("this tree", here), *others, *others[::-1], ("this tree", here)] if others \
        else [("this tree", here)]
    records = []
    for i, (label, src) in enumerate(turns):
        rec = run(src, check=args.check and i == 0, fwd=fwd)
        records.append({"variant": label, **rec})
        print(f"[record] {label}: {json.dumps(rec)}", flush=True)
    for label in dict.fromkeys(v for v, _ in turns):
        mine = [r for r in records if r["variant"] == label]
        for shape, *_ in shapes:
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
