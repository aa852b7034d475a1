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
    assert int(first.split()[0]) >= 42  # every module of the slices so far was imported
    assert {  # the training slice, the MoE slice, then the remaining families' configs
        "repro_torch.tree", "repro_torch.train.optimizer", "repro_torch.train.train_step",
        "repro_torch.train.data", "repro_torch.train.fault_tolerance",
        "repro_torch.train.checkpoint", "repro_torch.launch.train",
        "repro_torch.models.moe", "repro_torch.configs.qwen3_moe_30b_a3b",
        "repro_torch.configs.moonshot_v1_16b_a3b",
        "repro_torch.configs.qwen3_32b", "repro_torch.configs.granite_34b",
        "repro_torch.configs.h2o_danube3_4b", "repro_torch.configs.llava_next_mistral_7b",
        "repro_torch.configs.hubert_xlarge", "repro_torch.configs.jamba_1_5_large_398b",
        "repro_torch.parallel.opt_flags", "repro_torch.parallel.sharding",  # the parallel
        "repro_torch.launch.mesh", "repro_torch.launch.analysis",  # and launch layer
        "repro_torch.launch.cost", "repro_torch.launch.dryrun", "repro_torch.dtensor_util",
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


def _testing_imports(path: Path) -> set:
    """Modules of ``torch.testing`` a file imports (its private helpers
    among them)."""
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            found |= {a.name for a in node.names if a.name.startswith("torch.testing")}
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("torch.testing"):
            found.add(node.module)
    return found


def test_the_fake_process_group_is_the_one_private_torch_testing_import():
    """The dry run's fake process group comes from torch's private
    ``torch.testing._internal.distributed.fake_pg``, imported in
    ``launch/dryrun.py`` and nowhere else in the port or chip_smoke.py; the
    module still provides what the dry run uses."""
    paths = [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    found = {str(p.relative_to(ROOT)): m for p in paths if (m := _testing_imports(p))}
    assert found == {"src/repro_torch/launch/dryrun.py": {"torch.testing._internal.distributed.fake_pg"}}
    from torch.testing._internal.distributed import fake_pg

    from repro_torch.launch import dryrun

    assert dryrun.FakeStore is fake_pg.FakeStore


def _private_imports(path: Path) -> set:
    """Modules with a private (``_``, not ``__``) part that a file imports
    from."""
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                 else [])
        found |= {n for n in names if any(part.startswith("_") and not part.startswith("__")
                                           for part in n.split("."))}
    return found


def test_the_private_torch_names_the_port_reaches():
    """Besides the fake process group, the cost counter reaches three
    private torch modules, and patches one private method of DTensor's
    sharding propagator while it counts: each is named here, so that a
    torch that moves one fails this test, and the patch is undone on
    exit."""
    paths = [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
    found = {str(p.relative_to(ROOT)): m for p in paths if (m := _private_imports(p))}
    assert found == {
        "src/repro_torch/launch/dryrun.py": {"torch.testing._internal.distributed.fake_pg"},
        "src/repro_torch/launch/cost.py": {"torch.distributed.tensor._sharding_prop",
                                           "torch.utils._python_dispatch", "torch.utils._pytree"},
    }
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes  # noqa: F401

    from repro_torch.launch.cost import CostMode

    before = ShardingPropagator.__dict__["_propagate_tensor_meta_non_cached"]
    assert callable(before)
    with CostMode():
        assert ShardingPropagator.__dict__["_propagate_tensor_meta_non_cached"] is not before
    assert ShardingPropagator.__dict__["_propagate_tensor_meta_non_cached"] is before


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "src" / "repro_torch" / "kernels").glob("*.py")
))
def test_the_kernel_layer_imports_no_higher_layer(path):
    """The kernel wrappers sit below the model, the parallel layer, the
    launchers, training and serving, and import none of them."""
    above = {"models", "parallel", "launch", "train", "serve"}
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if isinstance(node, ast.ImportFrom) and node.level >= 2:
            assert (node.module or "").split(".")[0] not in above, (path, node.module)
        elif isinstance(node, ast.ImportFrom) and (node.module or "").startswith("repro_torch."):
            assert node.module.split(".")[1] not in above, (path, node.module)
