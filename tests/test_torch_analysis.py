"""The port's simlint (``repro_torch.analysis``) against the JAX package's:
the same findings, as (path, line, rule), on every tree both lint; none on
the port's own package; the two path-scoped determinism rules widened to
``repro_torch/...``; and tests/test_lint_fixtures.py's checks run against
the port's ``Linter``, ``RULES`` and CLI."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.analysis import RULES as REF_RULES  # noqa: E402
from repro.analysis import Linter as RefLinter  # noqa: E402
from repro_torch.analysis import RULES, Linter  # noqa: E402
from repro_torch.analysis.core import FileContext  # noqa: E402
from repro_torch.analysis.determinism import check_file  # noqa: E402
from repro_torch.analysis.lint import main as lint_main  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "lint_fixtures"
BAD, CLEAN = FIXTURES / "known_bad", FIXTURES / "known_clean"
BAD_DET = BAD / "repro" / "serverless" / "bad_det.py"
SCOPED = ("det-raw-randomstate", "det-set-iter")


def keys(findings):
    return [(f.path, f.line, f.rule) for f in findings]


def _findings(root):
    return Linter().lint_paths([str(root)])


def _at(findings, filename, rule):
    """Lines in ``filename`` where ``rule`` fired."""
    return sorted(f.line for f in findings
                  if f.path.endswith(filename) and f.rule == rule)


@pytest.fixture(scope="module")
def bad():
    return _findings(BAD)


# -- the same findings as the reference ---------------------------------------

@pytest.mark.parametrize("tree", ["tests/lint_fixtures/known_bad",
                                  "tests/lint_fixtures/known_clean",
                                  "src/repro", "benchmarks", "examples"])
def test_findings_equal_the_references(tree, monkeypatch):
    monkeypatch.chdir(ROOT)
    want = keys(RefLinter().lint_paths([tree]))
    assert keys(Linter().lint_paths([tree])) == want
    assert want or tree != "tests/lint_fixtures/known_bad"


def test_rule_catalogue_equals_the_references():
    assert {k: r.severity for k, r in RULES.items()} == {
        k: r.severity for k, r in REF_RULES.items()}


def test_shipped_tree_lints_clean_with_the_widened_scopes():
    """No finding on src/ (the port's package included), benchmarks/ and
    examples/."""
    roots = [str(ROOT / d) for d in ("src", "benchmarks", "examples")]
    findings = Linter().lint_paths(roots)
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_sites_with_reference_draws_carry_reasoned_suppressions():
    """The three port sites whose numpy draws are the reference's own (and
    must stay bit-equal) fire without their suppression comment."""
    sites = {"configs/__init__.py": 108, "examples/quickstart.py": 70,
             "examples/nas_dynamic.py": 57}
    for rel, line in sites.items():
        path = ROOT / "src" / "repro_torch" / rel
        lines = path.read_text().splitlines()
        assert "# simlint: ok(det-raw-randomstate, " in lines[line - 1], rel
        stripped = lines[:line - 1] + [lines[line - 1].split("  # simlint")[0]]
        src = "\n".join(stripped + lines[line:]) + "\n"
        fired = [f.line for f in check_file(FileContext(str(path), src))
                 if f.rule == "det-raw-randomstate"]
        assert fired == [line], rel


# -- the widened scopes ----------------------------------------------------------

@pytest.mark.parametrize("layer", ["serverless", "workflow"])
def test_scoped_rules_fire_under_the_port_package(layer, tmp_path):
    """bad_det.py copied under repro_torch/<layer>/: the port's linter fires
    the scoped rules on the original's lines; the reference's does not."""
    dst = tmp_path / "repro_torch" / layer / "bad_det.py"
    dst.parent.mkdir(parents=True)
    shutil.copy(BAD_DET, dst)
    port, ref = _findings(tmp_path), RefLinter().lint_paths([str(tmp_path)])
    orig = _findings(BAD_DET)
    for rule in SCOPED:
        assert _at(port, "bad_det.py", rule) == _at(orig, "bad_det.py", rule)
        assert _at(ref, "bad_det.py", rule) == []
    assert _at(port, "bad_det.py", "det-raw-randomstate") == [30]
    assert _at(port, "bad_det.py", "det-set-iter") == [35, 37, 41]
    # the unscoped rules fire alike in both
    assert [k for k in keys(port) if k[2] not in SCOPED] == [
        k for k in keys(ref) if k[2] not in SCOPED]


@pytest.mark.parametrize("rel, fired", [
    ("repro_torch/core/rng.py", {"det-set-iter": []}),
    ("repro_torch/models/draws.py", {"det-raw-randomstate": [30],
                                     "det-set-iter": []}),
    ("other/serverless/draws.py", {"det-raw-randomstate": [],
                                   "det-set-iter": []}),
])
def test_scope_edges(rel, fired, tmp_path):
    """Each package's core/rng.py may build RandomStates; set iteration is
    scoped to the serverless and workflow layers; a path outside both
    packages is outside both rules."""
    dst = tmp_path / rel
    dst.parent.mkdir(parents=True)
    shutil.copy(BAD_DET, dst)
    port = _findings(dst)
    want = {"det-raw-randomstate": [], **fired}
    for rule, lines in want.items():
        assert _at(port, dst.name, rule) == lines, rule
    assert _at(RefLinter().lint_paths([str(dst)]), dst.name,
               "det-raw-randomstate") == []


# -- tests/test_lint_fixtures.py's checks on the port's linter ----------------

def test_clean_tree_is_clean():
    assert _findings(CLEAN) == []


def test_every_rule_has_a_fixture(bad):
    fired = {f.rule for f in bad}
    missing = set(RULES) - fired - {"parse-error"}
    assert not missing, f"rules with no known-bad fixture: {sorted(missing)}"


@pytest.mark.parametrize("filename, rule, lines", [
    ("known_bad/repro/serverless/bad_det.py", "det-global-rng", [14, 18]),
    ("known_bad/repro/serverless/bad_det.py", "det-wallclock", [22, 26]),
    ("known_bad/repro/serverless/bad_det.py", "det-raw-randomstate", [30]),
    ("known_bad/repro/serverless/bad_det.py", "det-set-iter", [35, 37, 41]),
    ("known_bad/bad_units.py", "unit-mix", [5, 6, 7, 15, 18]),
    ("known_bad/bad_units.py", "unit-assign", [8, 9, 20, 21]),
    ("known_bad/bad_coverage.py", "trace-kind-dead", [16]),
    ("known_bad/bad_coverage.py", "trace-kind-undeclared", [30]),
    ("known_bad/bad_coverage.py", "event-unbound-handler", [34]),
    ("known_bad/bad_api.py", "api-unseeded-rng", [14, 21]),
    ("known_bad/bad_api.py", "api-frozen-mutation", [15, 16]),
])
def test_known_bad_lines(bad, filename, rule, lines):
    assert _at(bad, filename, rule) == lines


def test_conversions_and_bound_handlers_are_not_flagged(bad):
    # multiplication is a conversion; the correctly-bound push is fine
    assert all(x.line != 10 for x in bad if x.path.endswith("bad_units.py"))
    assert all(x.line != 33 for x in bad
               if x.path.endswith("bad_coverage.py"))


def test_suppressions_require_a_reason(bad):
    f = "known_bad/bad_suppression.py"
    assert _at(bad, f, "suppression-needs-reason") == [6]
    assert 6 in _at(bad, f, "det-wallclock")
    assert _at(bad, f, "suppression-unknown-rule") == [10]
    assert 10 in _at(bad, f, "det-wallclock")


def test_suppression_with_reason_suppresses():
    src = (CLEAN / "repro/serverless/clean.py").read_text()
    assert "simlint: ok(det-wallclock," in src and "time.time()" in src
    assert _findings(CLEAN / "repro/serverless/clean.py") == []


def test_docstring_mention_is_not_a_suppression(tmp_path):
    p = tmp_path / "doc.py"
    p.write_text('"""example: # simlint: ok(det-wallclock)"""\nx = 1\n')
    assert Linter().lint_paths([str(p)]) == []


@pytest.mark.parametrize("tree, fail_on, code", [
    (BAD, "never", 0), (BAD, "error", 1), (BAD, "warning", 1),
    (CLEAN, "warning", 0)])
def test_severity_threshold_exit_codes(tree, fail_on, code, capsys):
    assert lint_main([str(tree), "--fail-on", fail_on]) == code
    out = capsys.readouterr().out
    assert out.rstrip().endswith("simlint: clean" if tree == CLEAN
                                 else "warning(s)")


def test_cli_over_the_repository():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "src/",
         "benchmarks/", "examples/", "--fail-on", "warning"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "simlint: clean"
