"""The port's repro-lint CLI — run the four passes over the port, apply
suppressions and the port's baseline, report.

    python -m repro_torch.analysis [paths…] [--check] [--write-baseline]
                                   [--baseline FILE] [--report FILE]
                                   [--list-rules]

The flags and exit codes are the reference's (``repro.analysis.cli``):
0 clean, 1 findings survive suppression + baseline (only with
``--check``; the bare run always reports and exits 0), 2 usage error.
The default path is ``src/repro_torch`` under the repo root (found by
walking up to ``pyproject.toml``) and the default baseline is
``src/repro_torch/analysis/baseline.json``, the port's own.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Iterable, List, Optional, Tuple

from repro_torch.analysis import PASSES
from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.common import RULES, Finding, SourceFile

DEFAULT_ROOTS = ("src/repro_torch",)
DEFAULT_BASELINE = "src/repro_torch/analysis/baseline.json"


def find_repo_root(start: Optional[str] = None) -> Optional[str]:
    d = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                out.extend(os.path.join(dirpath, f)
                           for f in filenames if f.endswith(".py"))
    return sorted(set(out))


def all_findings(path: str, relpath: str, text: Optional[str] = None
                 ) -> Tuple[List[Finding], SourceFile]:
    """Every finding of one file, suppressed ones included."""
    sf = SourceFile(path, relpath, text=text)
    findings: List[Finding] = []
    if sf.parse_error is not None:
        findings.append(sf.parse_error)
    findings.extend(sf.bad_suppressions)
    for pass_run in PASSES:
        findings.extend(pass_run(sf))
    return sorted(set(findings)), sf


def analyze_file(path: str, relpath: str
                 ) -> Tuple[List[Tuple[Finding, str]], SourceFile]:
    """All unsuppressed findings for one file, paired with the stripped
    source line they sit on (the baseline snippet key)."""
    findings, sf = all_findings(path, relpath)
    lines = sf.text.splitlines()
    kept: List[Tuple[Finding, str]] = []
    for f in findings:
        if sf.is_suppressed(f):
            continue
        snippet = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        kept.append((f, snippet))
    return kept, sf


def run_paths(paths: Iterable[str], root: str
              ) -> List[Tuple[Finding, str]]:
    findings: List[Tuple[Finding, str]] = []
    for path in iter_py_files(paths):
        rel = os.path.relpath(os.path.abspath(path), root)
        rel = rel.replace(os.sep, "/")
        findings.extend(analyze_file(path, rel)[0])
    findings.sort(key=lambda fs: fs[0])
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-lint-torch",
        description="the port's static analysis: in-place safety, "
                    "collective uniformity, lock discipline, host syncs "
                    "in step programs")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to analyze (default: src/repro_torch "
                         "under the repo root)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any finding survives suppressions and "
                         "the baseline (the gate mode)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings to the baseline file "
                         "and exit 0")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help=f"baseline file (default: <repo>/{DEFAULT_BASELINE})")
    ap.add_argument("--report", default=None, metavar="FILE",
                    help="also write findings as JSON to FILE")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in sorted(RULES):
            print(f"{rule}  {RULES[rule]}")
        return 0

    root = find_repo_root()
    if root is None:
        root = os.getcwd()
    paths = args.paths or [os.path.join(root, d) for d in DEFAULT_ROOTS
                           if os.path.isdir(os.path.join(root, d))]
    missing = [p for p in paths if not os.path.exists(p)]
    if missing or not paths:
        print(f"repro-lint: no such path(s): {', '.join(missing) or '(none)'}",
              file=sys.stderr)
        return 2

    findings = run_paths(paths, root)

    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    if args.write_baseline:
        payload = baseline_mod.to_payload(findings)
        os.makedirs(os.path.dirname(baseline_path) or ".", exist_ok=True)
        with open(baseline_path, "w", encoding="utf-8") as f:
            f.write(baseline_mod.render(payload))
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    fresh, absorbed = baseline_mod.subtract(
        findings, baseline_mod.load(baseline_path))

    if args.report:
        with open(args.report, "w", encoding="utf-8") as f:
            json.dump({"findings": [fi.to_json() for fi, _ in fresh],
                       "baselined": absorbed}, f, indent=2)
            f.write("\n")

    for fi, _ in fresh:
        print(fi.render())
    tail = f"{len(fresh)} finding(s)"
    if absorbed:
        tail += f" ({absorbed} baselined)"
    print(f"repro-lint: {tail}")
    if fresh and args.check:
        return 1
    return 0
