"""Fixtures of the benchmark's tests: the repository's root and ``src`` on
the path, and a copy of the benchmark with test-sized cells beside the real
ones (``tiny_root``).  Run from the repository's root:

    python -m pytest portbench/tests -q
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

TINY = Path(__file__).resolve().parent / "tiny"
# each test-sized cell, and the real cell whose metrics it takes; its limits
# are its own (tiny/limits/), read at its size on the CPU
TINY_CELLS = {
    "tiny-dense.tiny_serve": "deepseek-7b.serve_longdoc",
    "tiny-dense.tiny_train": "deepseek-7b.train_8k",
    "tiny-moe.tiny_serve": "deepseek-7b.serve_longdoc",
    "tiny-moe.tiny_train": "deepseek-7b.train_8k",
}


def make_tiny_root(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` under ``dest``, with
    the test-sized configurations, mixes, limits and cells added as a later
    change would add them: as files, and entries in the manifest."""
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for n in ("tiny-dense", "tiny-moe"):
        shutil.copy(TINY / f"{n}.json", dest / "portbench" / "configs" / f"{n}.json")
    for n in ("tiny_serve", "tiny_train"):
        shutil.copy(TINY / f"{n}.json", dest / "portbench" / "workloads" / f"{n}.json")
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"] += [{"name": n, "source": "https://huggingface.co/", "file": f"portbench/configs/{n}.json",
                        "reduced": json.loads((TINY / f"{n}.json").read_text())["reduced"], "why": "test size"}
                       for n in ("tiny-dense", "tiny-moe")]
    for cell, like in TINY_CELLS.items():
        config, traffic = cell.split(".")
        man["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1,
                                 "why": "test size"})
        for m in man["end_to_end"] + man["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
        shutil.copy(TINY / "limits" / f"{cell}.json", dest / "portbench" / "limits" / f"{cell}.json")
    (dest / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import torch

    torch.set_num_threads(2)
    return make_tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def card():
    """Skips a test where no CUDA device is present; decided here, never at
    import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels)")
    return torch.device("cuda")
