"""The port's determinism linter (``repro_torch.analysis``) against the
reference's (``repro.analysis``):

* the port's linter on ``src/repro_torch/core`` and
  ``src/repro_torch/analysis``, under the repo's ``[tool.detlint]``
  configuration with its paths moved to the port's (pyproject.toml's own
  list stays the reference's: tests/test_detlint.py pins it), gives the
  findings the reference's linter gives on ``src/repro/core`` and
  ``src/repro/analysis``, by file, rule and function, every one
  suppressed with the same reason, none unsuppressed;
* on every fixture of tests/fixtures/detlint the two linters give the
  same findings, line, column, message and hint included (POL001's
  message less the reference's history, the named change);
* ``python -m repro_torch.analysis.detlint`` registers POL001/POL002 into
  the running module's registry and fails on a seeded violation.
"""
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

pytestmark = pytest.mark.sched

from repro.analysis import detlint as R  # noqa: E402
from repro_torch.analysis import detlint as P  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "detlint"
PYPROJECT = ROOT / "pyproject.toml"


def _moved(value):
    if isinstance(value, str):
        return value.replace("src/repro/", "src/repro_torch/")
    if isinstance(value, list):
        return [_moved(v) for v in value]
    if isinstance(value, dict):
        return {k: _moved(v) for k, v in value.items()}
    return value


def _port_config():
    """The repo's ``[tool.detlint]`` with every ``src/repro/`` path moved
    to ``src/repro_torch/``, read by the port's own config parser."""
    with PYPROJECT.open("rb") as fh:
        section = tomllib.load(fh)["tool"]["detlint"]
    return P.config_from_dict({"tool": {"detlint": _moved(section)}}, root=ROOT)


def _key(f, prefix):
    return (f.path[len(prefix):], f.rule, f.qualname, f.suppressed, f.suppression, f.reason)


def test_port_linter_on_the_port(monkeypatch):
    monkeypatch.chdir(ROOT)
    ref = R.lint_paths(["src/repro/core", "src/repro/analysis"], config=R.load_config(PYPROJECT))
    cfg = _port_config()
    assert cfg.paths == ["src/repro_torch/core", "src/repro_torch/analysis"]
    got = P.lint_paths(cfg.paths, config=cfg)
    assert got.unsuppressed == [] and ref.unsuppressed == [], \
        [(f.path, f.line, f.rule) for f in got.unsuppressed]
    assert got.n_files == ref.n_files
    want = sorted(_key(f, "src/repro/") for f in ref.findings)
    assert sorted(_key(f, "src/repro_torch/") for f in got.findings) == want
    assert len(want) == 9 and all(k[3] and k[5].strip() for k in want)


@pytest.mark.parametrize("fixture", sorted(p.name for p in FIXTURES.glob("*.py")))
def test_fixture_findings_equal(fixture):
    path = [str(FIXTURES / fixture)]
    want = R.lint_paths(path, config=R.Config(root=FIXTURES))
    got = P.lint_paths(path, config=P.Config(root=FIXTURES))
    assert [f.to_dict() for f in got.findings] == [f.to_dict() for f in want.findings]
    assert got.n_files == want.n_files == 1


def test_rule_registries_equal():
    want, got = R.all_rules(), P.all_rules()
    assert sorted(got) == sorted(want)
    for rid in want:
        assert got[rid].hint == want[rid].hint, rid


def _cli(*argv):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.detlint", *argv],
        capture_output=True, text=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )


def test_module_entry_point():
    listing = _cli("--list-rules")
    assert listing.returncode == 0, listing.stderr
    assert "POL001" in listing.stdout and "POL002" in listing.stdout
    proc = _cli(str(FIXTURES / "pol001_bad.py"), str(FIXTURES / "pol002_bad.py"),
                str(FIXTURES / "det002_bad.py"), "--no-config", "--format=github")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert all(r in proc.stdout for r in ("POL001", "POL002", "DET002"))
    assert "::error " in proc.stdout
    ok = _cli(str(FIXTURES / "det002_ok.py"), "--no-config")
    assert ok.returncode == 0, ok.stdout + ok.stderr
