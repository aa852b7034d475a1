"""The port imports neither JAX nor the JAX package, and neither does
chip_smoke.py."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), bad)
print(" ".join(names))
assert not bad, bad
"""


def test_port_modules_load_no_jax_and_no_repro():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    first, names = out.stdout.splitlines()[:2]
    assert int(first.split()[0]) >= 35  # every module of the slices so far was imported
    assert {  # the training slice, the MoE slice, then the remaining families' configs
        "repro_torch.tree", "repro_torch.train.optimizer", "repro_torch.train.train_step",
        "repro_torch.train.data", "repro_torch.train.fault_tolerance",
        "repro_torch.train.checkpoint", "repro_torch.launch.train",
        "repro_torch.models.moe", "repro_torch.configs.qwen3_moe_30b_a3b",
        "repro_torch.configs.moonshot_v1_16b_a3b",
        "repro_torch.configs.qwen3_32b", "repro_torch.configs.granite_34b",
        "repro_torch.configs.h2o_danube3_4b", "repro_torch.configs.llava_next_mistral_7b",
        "repro_torch.configs.hubert_xlarge", "repro_torch.configs.jamba_1_5_large_398b",
    } <= set(names.split())


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", ["chip_smoke.py", *sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch").rglob("*.py")
)])
def test_no_jax_or_repro_import_statement(path):
    roots = _imported_roots(ROOT / path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots
