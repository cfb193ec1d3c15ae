#!/usr/bin/env python3
"""Mutation check of the flash-attention kernels' parity tests, on a GPU.

    python3 tools/flash_mutants.py [NAME ...]

With names, only those mutants (and the unmutated kernels) run.  For each
mutant below, copies ``src/repro_torch`` and
``tests/test_torch_kernels_cuda.py`` into ``build/mutants/<name>/``,
applies one edit to one kernel source there (the f32 forward, the Hopper
forward, the Hopper building blocks of ``sm90.cuh`` that all three Hopper
kernels share, the shared masks of ``flash_mask.cuh``, the mma.sync
products of ``flash_mma.cuh``, the mma.sync dQ or dK/dV kernel, or the
Hopper dQ or dK/dV kernel), builds the kernels from the
copy and runs the flash cases of the CUDA test file, forward and backward
(``parity.flash_check`` and ``parity.flash_bwd_check``, the rules
``chip_smoke.py`` applies).  A mutant must fail at least one case; the
script exits non-zero if one survives, if an edit no longer applies, or if
the unmutated kernels fail.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")
TEST = Path("tests/test_torch_kernels_cuda.py")

# name → (source file in csrc, text in it, its replacement)
MUTANTS = {
    "none": ("", "", ""),
    # the masks shared by all three kernels
    "causal-strict": ("flash_mask.cuh", "if (causal) m = kp <= qp;", "if (causal) m = kp < qp;"),
    "sliding-off-by-one": ("flash_mask.cuh", "kp > qp - window", "kp >= qp - window"),
    # the forward
    "no-rescale": ("flash_attention_fwd.cu", "acc[4 * c + 2 * h] *= corr;",
                   "acc[4 * c + 2 * h] *= 1.0f;"),
    "no-skip-guard": ("flash_attention_fwd.cu", "if (kp >= Sk) x = -INFINITY;",
                      "if (kp >= Sk + 1) x = -INFINITY;"),
    # ... the next key tile copied into the stage being read
    "fwd-stage": ("flash_attention_fwd.cu", "load_kv(kl, (it + STAGES - 1) % STAGES);",
                  "load_kv(kl, it % STAGES);"),
    # ... one DEEP warp's (m, l, O) left out of the merge
    "fwd-merge": ("flash_attention_fwd.cu", "for (int w = 1; w < Sh::SPLIT; ++w) {",
                  "for (int w = 2; w < Sh::SPLIT; ++w) {"),
    # ... causal diagonal tiles taken as wholly inside the mask
    "fwd-whole-causal": ("flash_mask.cuh", "if (causal) r = r && (k_last <= q_start);",
                         "if (causal) r = r && (k_start <= q_start);"),
    # ... bf16's P without the first of its three parts
    "fwd-p3-no-hi": ("flash_mma.cuh",
                     "mma(d, P{a.mid, a.lo}, b);      // lo, then mid\n        mma_bf16(d, a.hi.x, b.x);",
                     "mma(d, P{a.mid, a.lo}, b);      // lo, then mid"),
    # the Hopper forward: P_lo dropped (P in bf16 alone, as FlashAttention-2/3)
    "sm90-no-p-lo": ("flash_attention_fwd_sm90.cu",
                     "wgmma_rs<HDP>(acc, &p_lo[4 * kk], dv);", ""),
    # the Hopper kernels' shared wgmma descriptor reading the 128-byte-swizzled
    # tiles as 64-byte-swizzled
    "sm90-swizzle": ("sm90.cuh", "| (1ull << 62);", "| (2ull << 62);"),
    # ... the second stage's mbarrier phase flipped
    "sm90-phase-flip": ("flash_attention_fwd_sm90.cu",
                        "const uint32_t phase = (it / STAGES) & 1;",
                        "const uint32_t phase = ((it / STAGES) & 1) ^ (s == 1);"),
    # ... their tensor maps: the rows of one head running on into the next, as
    # in a flattened 2-D map, so rows past S or Sk are no longer zero
    "sm90-2d-map": ("sm90.cuh",
                    "dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)heads};",
                    "dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows * heads, (cuuint64_t)heads};"),
    # the mma.sync pair's shared products: 3xTF32 without small*big', and
    # bf16's P and dS without their lo halves
    "tf32-no-small-big": ("flash_mma.cuh", "        mma_tf32(d, a.small, b.big);\n", ""),
    "bf16-no-lo": ("flash_mma.cuh", "        mma_bf16(d, a.lo.x, b.x);\n", ""),
    # ... a [k][n] B fragment read from the wrong row of its pair
    "tf32-kn-row": ("flash_mma.cuh", "split_tf32(s[2 * t * ld + g], b.big[0], b.small[0]);",
                    "split_tf32(s[(2 * t + 1) * ld + g], b.big[0], b.small[0]);"),
    # dQ: ds without its - delta
    "dq-no-delta": ("flash_attention_dq.cu", "s[4 * j + e] = p * (dp[4 * j + e] - dlt[h]);",
                    "s[4 * j + e] = p * dp[4 * j + e];"),
    # ... the LSE of the fragment's other row
    "dq-lse-row": ("flash_attention_dq.cu", "scale_log2, -lse2[h]))", "scale_log2, -lse2[h ^ 1]))"),
    # ... the next key tile copied into the stage being read
    "dq-stage": ("flash_attention_dq.cu", "load_kv(kn, (it + 1) & 1);", "load_kv(kn, it & 1);"),
    # ... one warp's partial dQ left out of the row block's sum
    "dq-reduction": ("flash_attention_dq.cu", "for (int o = 1; o < Sh::SPLIT; ++o) {",
                     "for (int o = 2; o < Sh::SPLIT; ++o) {"),
    # dK/dV: the causal diagonal dropped (k <= q turned into k < q) there only
    "dkv-causal-strict": (
        "flash_attention_dkv.cu",
        "&& flash::allowed(attention, window, causal, glob, qp, kp);",
        "&& flash::allowed(attention, window, causal, glob, qp, kp)"
        " && !(causal && kp == qp);"),
    # ... dK without its scale
    "dkv-no-dk-scale": ("flash_attention_dkv.cu", "const float sc = dk_warp ? scale : 1.f;",
                        "const float sc = 1.f;"),
    # ... the LSE of the neighbouring query column
    "dkv-lse-column": ("flash_attention_dkv.cu", "-cL[ql] * LOG2E", "-cL[ql ^ 1] * LOG2E"),
    # ... the causal diagonal query tile skipped
    "dkv-causal-diagonal": ("flash_attention_dkv.cu", "next_tile(causal ? k_start / BQ : 0);",
                            "next_tile(causal ? k_start / BQ + 1 : 0);"),
    # the Hopper dQ: dS_lo dropped (dS in bf16 alone)
    "dq-sm90-no-ds-lo": ("flash_attention_dq_sm90.cu",
                         "wgmma_rs<HDP>(acc, &ds_lo[4 * kk], dk);", ""),
    # ... a 64-byte swizzle in the descriptor of K as dS K's B operand
    "dq-sm90-swizzle": ("flash_attention_dq_sm90.cu",
                        "const uint64_t dk = sw128_desc(k_addr + kk * 16 * 128, BK * 128, 1024);",
                        "const uint64_t dk = sw128_desc(k_addr + kk * 16 * 128, BK * 128, 1024)"
                        " ^ (3ull << 62);"),
    # ... the second ring stage's full-barrier phase flipped
    "dq-sm90-phase-flip": ("flash_attention_dq_sm90.cu",
                           "const uint32_t phase = (it / STAGES) & 1;",
                           "const uint32_t phase = ((it / STAGES) & 1) ^ (s == 1);"),
    # ... the LSE of the fragment's other row
    "dq-sm90-lse-row": ("flash_attention_dq_sm90.cu",
                        "float p = exp2f(sc[i] * scale_log2 - lse2[h]);",
                        "float p = exp2f(sc[i] * scale_log2 - lse2[h ^ 1]);"),
    # ... the causal diagonal key tile skipped
    "dq-sm90-causal-diagonal": ("flash_attention_dq_sm90.cu", "--kt_hi;",
                                "--kt_hi;\n    if (causal) --kt_hi;"),
    # the Hopper dK/dV: P^T_lo dropped from dV, and dS^T_lo from dK
    "dkv-sm90-no-p-lo": ("flash_attention_dkv_sm90.cu",
                         "split_hi_lo<NS>(sc, hi, lo);            // P^T",
                         "split_hi_lo<NS>(sc, hi, lo);\n"
                         "                for (int i = 0; i < NS / 2; ++i) lo[i] = 0u;"),
    "dkv-sm90-no-ds-lo": ("flash_attention_dkv_sm90.cu",
                          "split_hi_lo<NS>(sc, hi, lo);            // dS^T",
                          "split_hi_lo<NS>(sc, hi, lo);\n"
                          "                for (int i = 0; i < NS / 2; ++i) lo[i] = 0u;"),
    # ... a 64-byte swizzle in the descriptor of dO and Q as B operands
    "dkv-sm90-swizzle": ("flash_attention_dkv_sm90.cu",
                         "const uint64_t db = sw128_desc(b_addr + kk * 16 * 128, BQ * 128, 1024);",
                         "const uint64_t db = sw128_desc(b_addr + kk * 16 * 128, BQ * 128, 1024)"
                         " ^ (3ull << 62);"),
    # ... the second ring stage's full-barrier phase flipped
    "dkv-sm90-phase-flip": ("flash_attention_dkv_sm90.cu",
                            "const uint32_t phase = (it / STAGES) & 1;",
                            "const uint32_t phase = ((it / STAGES) & 1) ^ (s == 1);"),
    # ... the LSE of the neighbouring query column
    "dkv-sm90-lse-column": ("flash_attention_dkv_sm90.cu",
                            "float p = exp2f(sc[i] * scale_log2 - lse2[c]);",
                            "float p = exp2f(sc[i] * scale_log2 - lse2[c ^ 1]);"),
    # ... the causal diagonal query tile skipped
    "dkv-sm90-causal-diagonal": ("flash_attention_dkv_sm90.cu",
                                 "if (qt_lo == nq) qt_hi = -1;",
                                 "if (qt_lo == nq) qt_hi = -1;\n    if (causal) ++qt_lo;"),
}


def run(name: str, src: str, old: str, new: str) -> tuple[bool, str]:
    """→ (the flash cases all passed, pytest's summary lines)."""
    work = ROOT / "build" / "mutants" / name
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", work / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (work / "tests").mkdir(parents=True)
    shutil.copy(ROOT / TEST, work / TEST)
    shutil.copy(ROOT / "pyproject.toml", work / "pyproject.toml")
    if old:
        path = work / CSRC / src
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"mutant {name}: {old!r} occurs {text.count(old)} times in {src}")
        path.write_text(text.replace(old, new))
    env = dict(os.environ, PYTHONPATH=str(work / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p", "no:cacheprovider",
         "-m", "cuda", "-k", "flash_matches or flash_fwd or flash_sm90 or flash_bwd", str(TEST)],
        cwd=work, env=env, capture_output=True, text=True, timeout=900)
    summary = (proc.stdout.strip().splitlines() or ["(no output)"])[-1]
    return proc.returncode == 0 and " passed" in summary, summary


def main() -> None:
    names = sys.argv[1:]
    unknown = [n for n in names if n not in MUTANTS]
    if unknown:
        raise SystemExit(f"unknown mutants {unknown}; known: {list(MUTANTS)}")
    bad = []
    for name, (src, old, new) in MUTANTS.items():
        if names and name != "none" and name not in names:
            continue
        passed, summary = run(name, src, old, new)
        edit = f"{src}: {old!r} -> {new!r}" if old else "unmutated kernels"
        print(f"[mutant] {name}: {edit}: {summary}", flush=True)
        if passed != (name == "none"):
            bad.append(name)
    if bad:
        raise SystemExit(f"flash_mutants: FAIL: {bad} (a mutant passed, or the kernel failed)")
    print(f"flash_mutants: every one of {len(names) or len(MUTANTS) - 1} mutants fails the "
          "parity check")


if __name__ == "__main__":
    main()
