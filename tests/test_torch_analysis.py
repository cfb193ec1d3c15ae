"""The port's repro-lint (src/repro_torch/analysis): each pass against its
fixtures (tests/fixtures/torch_analysis), the suppression, baseline and
CLI mechanics, the copied passes held against the reference's on the
same inputs, the registry and the in-place table against the reference's
traced functions and donation sites, mutants of real port files, and the
lint-clean-port and fresh-baseline meta-gates.

The lint is stdlib-only and runs in-process; one subprocess test pins
tools/repro_lint_torch.py and one the import of the package without
torch.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import locks as ref_locks
from repro.analysis.common import SourceFile as RefSourceFile
from repro.analysis.retrace import _collect_traced
from repro_torch.analysis import PASSES, RULES, SourceFile, donation, retrace
from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import locks as port_locks
from repro_torch.analysis.cli import (DEFAULT_BASELINE, DEFAULT_ROOTS, analyze_file, main,
                                      run_paths)
from repro_torch.analysis.common import package_files

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_analysis"
REF_FIXTURES = REPO / "tests" / "fixtures" / "analysis"
PORT = REPO / "src" / "repro_torch"


# the host-sync fixtures' step programs, {def: host-side inputs}: outside
# the port no def is in the registry, so the test names the roots
FIXTURE_PROGRAMS = {
    "bad_retrace.py": {"step": ("env_steps",), "serve": ()},
    "good_retrace.py": {"step": ("env_steps", "count")},
    "suppressed.py": {"step": ()},
}


def lint(name: str):
    """Unsuppressed (finding, snippet) pairs for one fixture, its step
    programs' R401/R404 findings included."""
    found, sf = analyze_file(str(FIXTURES / name), name)
    lines = sf.text.splitlines()
    found += [(f, lines[f.line - 1])
              for f, _, _ in retrace.sync_sites(sf, FIXTURE_PROGRAMS.get(name, {}))
              if not sf.is_suppressed(f)]
    return sorted(found)


def rules_at(found):
    return sorted((f.rule, f.line) for f, _ in found)


def lint_text(text: str, relpath: str = "mem.py"):
    sf = SourceFile("<mem>", relpath, text=text)
    found = list(sf.bad_suppressions)
    for p in PASSES:
        found.extend(p(sf))
    return sorted(f for f in set(found) if not sf.is_suppressed(f))


# -- each pass against its fixtures ----------------------------------------------

BAD = {
    "bad_donation.py": [("D101", 11), ("D101", 17), ("D101", 22), ("D101", 29)],
    "bad_collectives.py": [("C201", 20), ("C201", 26), ("C201", 31), ("C202", 35),
                           ("C202", 36)],
    "bad_locks.py": [("L301", 22), ("L302", 38), ("L303", 33)],
    "bad_retrace.py": [("R401", 15), ("R401", 25), ("R404", 17), ("R404", 18),
                       ("R404", 19), ("R404", 26), ("R404", 27), ("R404", 28),
                       ("R404", 32), ("R404", 34), ("R404", 35)],
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_fixture_fires_exactly_its_rules(name):
    assert rules_at(lint(name)) == BAD[name]


@pytest.mark.parametrize("name", ["good_donation.py", "good_collectives.py",
                                  "good_locks.py", "good_retrace.py"])
def test_good_fixture_is_clean(name):
    assert lint(name) == []


# -- suppression, X001, baseline, CLI --------------------------------------------


def _suppression(tmp_path):
    # the justified waivers (def-line and standalone forms) hold; the
    # empty-reason waiver yields X001 and leaves its R404 alive; a
    # repro-lint comment that is not a disable is an X001 too
    assert rules_at(lint("suppressed.py")) == [("R404", 15), ("X001", 15), ("X001", 25)]


def _x001_empty_reason(tmp_path):
    text = "import torch\n\ndef f(x):  # repro-lint: disable=R404()\n    return x\n"
    assert [f.rule for f in lint_text(text)] == ["X001"]


def _x000_parse_error(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    assert [f.rule for f, _ in analyze_file(str(bad), "broken.py")[0]] == ["X000"]


def _baseline_round_trip(tmp_path):
    found = lint("bad_retrace.py")
    path = tmp_path / "baseline.json"
    path.write_text(baseline_mod.render(baseline_mod.to_payload(found)))
    fresh, absorbed = baseline_mod.subtract(found, baseline_mod.load(str(path)))
    assert fresh == [] and absorbed == len(found)


def _baseline_matches_snippets(tmp_path):
    found = lint("bad_locks.py")
    path = tmp_path / "baseline.json"
    path.write_text(baseline_mod.render(baseline_mod.to_payload(found)))
    shifted = tmp_path / "bad_locks.py"
    shifted.write_text("# an unrelated leading comment\n\n"
                       + (FIXTURES / "bad_locks.py").read_text())
    moved = analyze_file(str(shifted), "bad_locks.py")[0]
    assert {f.line for f, _ in moved} != {f.line for f, _ in found}
    fresh, absorbed = baseline_mod.subtract(moved, baseline_mod.load(str(path)))
    assert fresh == [] and absorbed == len(found)


def _baseline_multiset(tmp_path):
    found = lint("bad_donation.py")
    path = tmp_path / "baseline.json"
    path.write_text(baseline_mod.render(baseline_mod.to_payload(found[:1])))
    fresh, absorbed = baseline_mod.subtract(found, baseline_mod.load(str(path)))
    assert absorbed == 1 and len(fresh) == len(found) - 1


def _cli_check_fails_on_bad(tmp_path):
    empty = str(tmp_path / "none.json")
    for name in sorted(set(BAD) - set(FIXTURE_PROGRAMS)):
        assert main([str(FIXTURES / name), "--check", "--baseline", empty]) == 1, name
    # the host-sync rules reach registered programs only: a copy of a port
    # module under a repro_torch directory stands for that module
    module, before, after, _ = MUTANTS["R404: .item() in the loop step"]
    copy = tmp_path / "src" / "repro_torch" / module
    copy.parent.mkdir(parents=True)
    copy.write_text((PORT / module).read_text().replace(before, after, 1))
    assert main([str(copy), "--check", "--baseline", empty]) == 1


def _cli_check_passes_on_good(tmp_path):
    empty = str(tmp_path / "none.json")
    for name in ("good_donation.py", "good_collectives.py", "good_locks.py",
                 "good_retrace.py"):
        assert main([str(FIXTURES / name), "--check", "--baseline", empty]) == 0, name


def _cli_without_check_exits_zero(tmp_path):
    assert main([str(FIXTURES / "bad_locks.py"), "--baseline",
                 str(tmp_path / "none.json")]) == 0


def _cli_missing_path_is_usage_error(tmp_path):
    assert main(["/no/such/path.py", "--check"]) == 2


def _cli_write_baseline_then_check(tmp_path):
    base = str(tmp_path / "baseline.json")
    target = str(FIXTURES / "bad_collectives.py")
    assert main([target, "--write-baseline", "--baseline", base]) == 0
    assert main([target, "--check", "--baseline", base]) == 0


def _cli_report_artifact(tmp_path):
    report = tmp_path / "report.json"
    main([str(FIXTURES / "bad_collectives.py"), "--baseline", str(tmp_path / "none.json"),
          "--report", str(report)])
    payload = json.loads(report.read_text())
    assert {f["rule"] for f in payload["findings"]} == {"C201", "C202"}
    assert all({"file", "line", "rule", "name", "message"} <= set(f)
               for f in payload["findings"])


def _cli_list_rules(tmp_path):
    assert main(["--list-rules"]) == 0


MECHANICS = {f.__name__[1:]: f for f in (
    _suppression, _x001_empty_reason, _x000_parse_error, _baseline_round_trip,
    _baseline_matches_snippets, _baseline_multiset, _cli_check_fails_on_bad,
    _cli_check_passes_on_good, _cli_without_check_exits_zero,
    _cli_missing_path_is_usage_error, _cli_write_baseline_then_check, _cli_report_artifact,
    _cli_list_rules)}


@pytest.mark.parametrize("case", sorted(MECHANICS))
def test_mechanics(case, tmp_path):
    MECHANICS[case](tmp_path)


def test_rule_table():
    assert set(RULES) == {"X000", "X001", "D101", "D102", "C201", "C202", "L301", "L302",
                          "L303", "R401", "R404"}


# -- the copied passes against the reference's, on the same inputs -----------------

SAME_INPUTS = sorted(str(p.relative_to(REPO)) for p in REF_FIXTURES.glob("*.py")) + sorted(
    str(p.relative_to(REPO)) for p in (PORT / "service").glob("*.py"))


def _locks_and_common(sf, locks_run):
    found = list(sf.bad_suppressions) + ([sf.parse_error] if sf.parse_error else [])
    found += locks_run(sf)
    return sorted((f.line, f.rule, f.message if f.rule != "X001" else "", sf.is_suppressed(f))
                  for f in set(found))


@pytest.mark.parametrize("rel", SAME_INPUTS)
def test_locks_and_common_match_the_reference(rel):
    ref = RefSourceFile(str(REPO / rel), rel)
    port = SourceFile(str(REPO / rel), rel)
    assert _locks_and_common(port, port_locks.run) == _locks_and_common(ref, ref_locks.run)
    # the baseline a run of either would write, byte for byte
    lines = port.text.splitlines()
    pairs = [(f, lines[f.line - 1]) for f in port_locks.run(port) if not port.is_suppressed(f)]
    ref_pairs = [(f, lines[f.line - 1]) for f in ref_locks.run(ref) if not ref.is_suppressed(f)]
    from repro.analysis import baseline as ref_baseline
    assert baseline_mod.render(baseline_mod.to_payload(pairs)) == ref_baseline.render(
        ref_baseline.to_payload(ref_pairs))


# -- the registry and the in-place table against the reference ---------------------


def _reference_traced():
    out = set()
    src = REPO / "src" / "repro"
    for path in sorted(src.rglob("*.py")):
        rel = str(path.relative_to(src))
        sf = RefSourceFile(str(path), rel)
        for t in _collect_traced(sf):
            parts = [getattr(t.fn, "name", "<lambda>")]
            parts += [a.name for a in _ref_ancestors(t.fn)]
            out.add(f"{rel}::{'.'.join(reversed(parts))}")
    return out


def _ref_ancestors(node):
    from repro.analysis.common import ancestors
    return [a for a in ancestors(node) if isinstance(a, (ast.FunctionDef, ast.ClassDef))]


def test_registry_covers_every_reference_traced_function():
    traced = _reference_traced()
    assert len(traced) == 38
    refs = {p.ref for p in retrace.REGISTRY}
    assert traced <= refs, sorted(traced - refs)
    assert all(prog.port for prog in retrace.REGISTRY)


def test_registry_port_functions_resolve():
    files = package_files()
    missing = [p for prog in retrace.REGISTRY for p in prog.port
               if retrace.split_port(p)[1] not in files[retrace.split_port(p)[0]].defs]
    assert not missing, missing


def test_inplace_table_covers_every_reference_donation_site():
    sites = set()
    src = REPO / "src" / "repro"
    for path in sorted(src.rglob("*.py")):
        if "analysis" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "donate_argnums":
                        sites.add(f"{path.relative_to(src)}:{kw.lineno}")
    assert len(sites) == 6
    covered = {e.site for e in donation.IN_PLACE} | {n.site for n in donation.NO_COUNTERPART}
    assert sites == covered
    assert all(n.reason for n in donation.NO_COUNTERPART)


@pytest.mark.parametrize("entry", donation.IN_PLACE, ids=lambda e: f"{e.module}::{e.func}")
def test_inplace_entry_matches_its_signature(entry):
    # D102: the entry's argument at its position in the function's signature
    sf = package_files()[entry.module]
    assert not [f for f in donation.run(sf) if f.rule == "D102"]
    fn = sf.defs[entry.func]
    params = [a.arg for a in fn.args.posonlyargs + fn.args.args if a.arg not in ("self", "cls")]
    assert params[entry.pos] == entry.arg


@pytest.fixture(scope="module")
def inplace_cases():
    import torch

    from repro_torch.launch import lint_witness
    torch.manual_seed(0)
    return lint_witness.inplace_cases("cpu")


@pytest.mark.parametrize("entry", donation.IN_PLACE, ids=lambda e: f"{e.module}::{e.func}")
def test_inplace_entry_aliases_on_cpu(entry, inplace_cases):
    from repro_torch.launch import lint_witness
    case = inplace_cases[entry]
    if entry.func.startswith("ShardedExecutor"):
        with lint_witness.world_one("gloo"):
            assert case()
    else:
        assert case()


# -- mutants of real port files ------------------------------------------------------

MUTANTS = {
    "R404: .item() in the loop step": (
        "runtime/loop.py",
        "            loss = loss / schedule.learns\n",
        "            loss = loss / schedule.learns + 0.0 * loss.item()\n", "R404"),
    "D101: the old replay binding read after run_chunk": (
        "runtime/executors.py",
        "            state, last = self.run_chunk(state, length)\n",
        "            new_state, last = self.run_chunk(state, length)\n"
        "            stale = state.replay.count\n"
        "            state = new_state\n", "D101"),
    "C201: an all_reduce under a rank test": (
        "launch/multiprocess.py",
        '    dist.all_reduce(errs, op=dist.ReduceOp.MAX, group=mesh.group("pod"))\n',
        "    if dist.get_rank() == 0:\n"
        '        dist.all_reduce(errs, op=dist.ReduceOp.MAX, group=mesh.group("pod"))\n',
        "C201"),
    "C202: a typo'd axis": (
        "launch/multiprocess.py", 'group=mesh.group("pod"))', 'group=mesh.group("pods"))',
        "C202"),
    "L301: a guarded read moved out of its lock": (
        "service/server.py",
        "        with self._lock:\n            return self._inserts\n",
        "        with self._lock:\n            pass\n        return self._inserts\n", "L301"),
    "D102: the in-place argument renamed": (
        "core/replay.py",
        "    def flush(self, state: ReplayState) -> ReplayState:",
        "    def flush(self, st: ReplayState) -> ReplayState:", "D102"),
}


@pytest.mark.parametrize("name", sorted(MUTANTS))
def test_mutant_of_a_port_file_fires(name, tmp_path):
    module, before, after, rule = MUTANTS[name]
    src = (PORT / module).read_text()
    assert before in src
    mutated = tmp_path / Path(module).name
    text = src.replace(before, after, 1)
    mutated.write_text(text)
    rel = f"src/repro_torch/{module}"
    assert not [f for f, _ in analyze_file(str(PORT / module), rel)[0]]
    found = analyze_file(str(mutated), rel)[0]
    line = text[:text.index(after)].count("\n") + 1
    span = range(line, line + after.count("\n") + 1)
    assert [f for f, _ in found if f.rule == rule and f.line in span], found


# -- the package stays stdlib-only -----------------------------------------------------


def test_analysis_package_is_stdlib_only():
    allowed = {"__future__", "argparse", "ast", "dataclasses", "io", "json", "os", "re",
               "sys", "tokenize", "typing"}
    for py in (PORT / "analysis").glob("*.py"):
        for node in ast.walk(ast.parse(py.read_text())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            for m in mods:
                assert m.split(".")[0] in allowed or m.startswith("repro_torch.analysis"), (
                    f"{py.name} imports {m} — repro_torch.analysis is stdlib-only")


def test_analysis_imports_without_torch():
    code = ("import sys; import repro_torch.analysis.cli; "
            "bad = [m for m in ('torch', 'numpy', 'jax', 'repro') if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- meta-gates --------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_findings():
    return run_paths([str(REPO / d) for d in DEFAULT_ROOTS], str(REPO))


def test_port_tree_is_lint_clean(port_findings):
    # fixed or suppressed with a reason: the port's baseline stays empty
    assert [f.render() for f, _ in port_findings] == []


def test_port_baseline_is_fresh(port_findings):
    committed = (REPO / DEFAULT_BASELINE).read_text()
    assert baseline_mod.render(baseline_mod.to_payload(port_findings)) == committed
    assert json.loads(committed)["findings"] == []


def test_tools_entry_point_gates_the_port():
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "repro_lint_torch.py"),
                           "--check"], cwd=str(REPO), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "repro-lint: 0 finding(s)"


# -- the witness's reading of the lint (the card's half runs in chip_smoke.py) -----


@pytest.mark.parametrize("where,kind,scoped", [
    (("serve/engine.py", "torch.from_numpy(self.buckets.pad(prompt))"), "finding", True),
    (("runtime/loop.py", "eps = epsilon_schedule(cfg, state.env_steps)"), "missed", True),
    (("runtime/dse.py", "def solve("), "missed", False),
])
def test_lint_index_classifies_a_line(where, kind, scoped):
    # a sync at any port line the lint does not flag is a miss, in the
    # registry's scope or not
    from repro_torch.launch.lint_witness import LintIndex
    module, text = where
    src = (PORT / module).read_text()
    line = src[:src.index(text)].count("\n") + 1
    verdict = LintIndex().classify(str(PORT / module), line)
    assert verdict.kind == kind
    assert verdict.scoped == scoped
    assert verdict.waived == (kind == "finding")


def test_call_recorder_names_the_registry_entries_a_run_reaches():
    import torch

    from repro_torch.agents.dqn import DQNConfig, make_dqn
    from repro_torch.envs.classic import make_vec
    from repro_torch.launch.lint_witness import CallRecorder, LintIndex, registry_reached
    spec, _, _ = make_vec("cartpole", 1)
    agent = make_dqn(spec, DQNConfig(hidden=(8,)))
    state = agent.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"obs": torch.rand((4, 4), generator=g), "action": torch.zeros(4, dtype=torch.int32),
             "reward": torch.rand(4, generator=g), "next_obs": torch.rand((4, 4), generator=g),
             "done": torch.zeros(4)}
    with CallRecorder() as rec:
        agent.learn(state, batch, torch.ones(4))
    entered = rec.entered(LintIndex())
    assert {"agents/dqn.py::make_dqn.learn", "agents/dqn.py::make_dqn.grads_fn"} <= entered
    reached = registry_reached(entered)
    assert "agents/dqn.py::make_dqn.grads_fn.loss_fn" in reached
    assert "agents/ddpg.py::make_ddpg.learn.loss_fn" not in reached


def test_waivers_name_their_roadmap_item():
    from repro_torch.launch.lint_witness import waivers_by_item
    items = waivers_by_item()
    assert set(items) == {"L301", "R404"}
    assert "none" not in items["R404"] and sum(items["R404"].values()) == 7
