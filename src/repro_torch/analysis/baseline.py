"""Baseline bookkeeping: the port's committed
``src/repro_torch/analysis/baseline.json`` (a copy of
``repro.analysis.baseline``; the reference's ``analysis/baseline.json``
is its own and is never written here).

The baseline is the escape hatch that lets the gate be blocking from
day one: findings recorded in it are known debt, not new breakage.  A
baselined finding is matched by ``(file, rule, snippet)`` — the
*stripped source line text*, not the line number — so unrelated edits
that shift lines don't resurrect old findings, while editing the
flagged line itself (you touched it, you own it) does.  Matching is a
multiset: two identical findings in the baseline absorb at most two
fresh ones.

The file is written sorted and newline-terminated so a fresh
``--write-baseline`` over an unchanged repo is byte-identical to the
committed one (the stale-baseline meta-test asserts exactly that).
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

from repro_torch.analysis.common import Finding

BASELINE_VERSION = 1

Key = Tuple[str, str, str]  # (file, rule, stripped snippet)


def finding_key(finding: Finding, snippet: str) -> Key:
    return (finding.file, finding.rule, snippet.strip())


def to_payload(findings: List[Tuple[Finding, str]]) -> dict:
    entries = [
        {"file": f.file, "line": f.line, "rule": f.rule, "name": f.name,
         "snippet": snippet.strip(), "message": f.message}
        for f, snippet in sorted(findings, key=lambda fs: fs[0])]
    return {"version": BASELINE_VERSION, "findings": entries}


def render(payload: dict) -> str:
    return json.dumps(payload, indent=2, sort_keys=True) + "\n"


def load(path: str) -> Dict[Key, int]:
    """key → multiplicity; missing file = empty baseline."""
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except FileNotFoundError:
        return {}
    if not text.strip():
        return {}
    payload = json.loads(text)
    counts: Dict[Key, int] = {}
    for e in payload.get("findings", ()):
        key = (e["file"], e["rule"], e.get("snippet", ""))
        counts[key] = counts.get(key, 0) + 1
    return counts


def subtract(findings: List[Tuple[Finding, str]],
             baseline: Dict[Key, int]
             ) -> Tuple[List[Tuple[Finding, str]], int]:
    """(fresh findings not absorbed by the baseline, absorbed count)."""
    remaining = dict(baseline)
    fresh: List[Tuple[Finding, str]] = []
    absorbed = 0
    for f, snippet in findings:
        key = finding_key(f, snippet)
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
            absorbed += 1
        else:
            fresh.append((f, snippet))
    return fresh, absorbed
