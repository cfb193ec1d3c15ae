#!/usr/bin/env python3
"""Mutation check of the replay kernels' tests, on a GPU.

    python3 tools/replay_mutants.py

For each mutant below, copies ``src/repro_torch`` and
``tests/test_torch_kernels_cuda.py`` into ``build/mutants/<name>/``,
applies one edit to the descent (``csrc/descend.cuh``, which the sample
and fused sample+gather kernels share) or to the gather
(``csrc/gather.cu``) there, builds the kernels from the copy and runs the
replay cases of the CUDA test file (every case but the flash ones: the
sample under ``parity.sample_ties``, the gathers and the fused kernel bit
for bit, the padded-tail cascade, the split replay's launches).  A mutant
must fail at least one case; the script prints how many each fails and
exits non-zero if one survives, if an edit no longer applies, or if the
unmutated kernels fail.  The tests run with PyTorch's expandable segments,
so that memory past the tensors in use is unmapped and a read far past
the tree faults.
"""

from __future__ import annotations

import os
import re
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
    # the lane totals' exclusive prefix taken from two lanes back
    "lane-scan-shift": ("descend.cuh", "float before = __shfl_up_sync(kFull, s, 1);",
                        "float before = __shfl_up_sync(kFull, s, 2);"),
    # the in-lane search never picks a lane's first child
    "in-lane-second-child": ("descend.cuh", "for (int i = C - 2; i >= 0; --i) {",
                             "for (int i = C - 2; i >= 1; --i) {"),
    # the leaf priority taken from the last row read even after the clamp
    "no-reread-after-clamp": (
        "descend.cuh",
        "*pri = *leaf == group ? row_val : tree[lv.off[lv.n_levels - 1] + *leaf];",
        "*pri = row_val;"),
    # the padding-node guard removed: the descent reads rows past its level
    "no-padding-guard": (
        "descend.cuh",
        "if (group * K >= lv.off[l + 1] - lv.off[l]) { group = capacity; break; }", ""),
    # the gather: a leaf's row bytes taken from the next table entry
    "next-row-bytes": ("gather.cu", "const long long rb = tab.row_bytes[j];",
                       "const long long rb = tab.row_bytes[j + 1];"),
    # the gather: indices not clamped into the leaf's rows
    "no-clamp": ("gather.cu", "r = r < 0 ? 0 : (r >= n ? n - 1 : r);", ""),
}


def run(name: str, src: str, old: str, new: str) -> tuple[bool, int, str]:
    """→ (the replay cases all passed, how many failed, pytest's summary)."""
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
    env = dict(os.environ, PYTHONPATH=str(work / "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p", "no:cacheprovider",
         "-m", "cuda", "-k", "not flash", str(TEST)],
        cwd=work, env=env, capture_output=True, text=True, timeout=900)
    summary = (proc.stdout.strip().splitlines() or ["(no output)"])[-1]
    failed = sum(int(n) for n in re.findall(r"(\d+) (?:failed|error)", summary))
    return proc.returncode == 0 and " passed" in summary, failed, summary


def main() -> None:
    bad = []
    for name, (src, old, new) in MUTANTS.items():
        passed, failed, summary = run(name, src, old, new)
        edit = f"{src}: {old!r} -> {new!r}" if old else "unmutated kernels"
        print(f"[mutant] {name}: {edit}: {failed} failed: {summary}", flush=True)
        if passed != (name == "none"):
            bad.append(name)
    if bad:
        raise SystemExit(f"replay_mutants: FAIL: {bad} (a mutant passed, or the kernel failed)")
    print(f"replay_mutants: every one of {len(MUTANTS) - 1} mutants fails the replay tests")


if __name__ == "__main__":
    main()
