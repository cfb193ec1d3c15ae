#!/usr/bin/env python3
"""Mutation check of the flash-attention kernel's parity test, on a GPU.

    python3 tools/flash_mutants.py

For each mutant below, copies ``src/repro_torch`` and
``tests/test_torch_kernels_cuda.py`` into ``build/mutants/<name>/``,
applies one edit to ``csrc/flash_attention_fwd.cu`` there, builds the
kernel from the copy and runs the flash cases of the CUDA test file
(``parity.flash_check``, the rule ``chip_smoke.py`` applies).  A mutant
must fail at least one case; the script exits non-zero if one survives,
if an edit no longer applies, or if the unmutated kernel fails.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = Path("src/repro_torch/kernels/csrc/flash_attention_fwd.cu")
TEST = Path("tests/test_torch_kernels_cuda.py")

# name → (text in the kernel, its replacement)
MUTANTS = {
    "none": ("", ""),
    "causal-strict": ("if (causal) m = kp <= qp;", "if (causal) m = kp < qp;"),
    "no-rescale": ("acc[i][jj] *= corr;", "acc[i][jj] *= 1.0f;"),
    "no-skip-guard": ("if (kp >= Sk) x = -INFINITY;", "if (kp >= Sk + 1) x = -INFINITY;"),
    "sliding-off-by-one": ("kp > qp - window", "kp >= qp - window"),
}


def run(name: str, old: str, new: str) -> tuple[bool, str]:
    """→ (the flash cases all passed, pytest's summary lines)."""
    work = ROOT / "build" / "mutants" / name
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", work / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (work / "tests").mkdir(parents=True)
    shutil.copy(ROOT / TEST, work / TEST)
    shutil.copy(ROOT / "pyproject.toml", work / "pyproject.toml")
    if old:
        src = (work / CU).read_text()
        if src.count(old) != 1:
            raise SystemExit(f"mutant {name}: {old!r} occurs {src.count(old)} times in the kernel")
        (work / CU).write_text(src.replace(old, new))
    env = dict(os.environ, PYTHONPATH=str(work / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p", "no:cacheprovider",
         "-m", "cuda", "-k", "flash_matches", str(TEST)],
        cwd=work, env=env, capture_output=True, text=True, timeout=900)
    summary = (proc.stdout.strip().splitlines() or ["(no output)"])[-1]
    return proc.returncode == 0 and " passed" in summary, summary


def main() -> None:
    bad = []
    for name, (old, new) in MUTANTS.items():
        passed, summary = run(name, old, new)
        edit = f"{old!r} -> {new!r}" if old else "unmutated kernel"
        print(f"[mutant] {name}: {edit}: {summary}", flush=True)
        if passed != (name == "none"):
            bad.append(name)
    if bad:
        raise SystemExit(f"flash_mutants: FAIL: {bad} (a mutant passed, or the kernel failed)")
    print(f"flash_mutants: every one of {len(MUTANTS) - 1} mutants fails the parity check")


if __name__ == "__main__":
    main()
