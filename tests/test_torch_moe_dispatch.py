"""The port's MoE dispatch on DTensors (``repro_torch.models.moe``'s
``_placed_route`` and ``_placed_experts``): the ``[E, C, D]`` slab placed,
E on `model` and C over the batch axes, never whole on a device.

* The dry run on the 16x16 mesh against the reference's, run live in a
  subprocess (``python -m repro.launch.dryrun``, XLA on 512 host devices):
  the MoE prefill cells fit one H100, their per-device FLOPs within
  0.8-1.25x the reference's ``hlo_flops`` and their peak within 1.5x its
  ``peak_memory_bytes``; the MoE ``train_4k`` cells count no more FLOPs
  than the reference's, and peak below the replicated slab's (173.74 and
  174.34 GB, the counts before the slab was placed).  Train and decode
  peaks are not held to the reference's: its memory analysis on host
  devices overstates those steps.
* A cell without experts (deepseek-7b x prefill_32k) counts what it
  counted before, to the FLOP and the byte.
* On gloo meshes of 2x2 and 3x2 ranks (the second pads C = 16 to 18
  slots over 3 batch ranks), ``apply_moe`` with and without ``moe_ep``
  against the same layer on whole tensors: output, aux and the grads of
  x and of every weight within 1e-5 of each tensor's largest magnitude
  (fp32; the sums over ranks run in another order), and ``route``'s
  fields equal field for field, pairs dropped at capacity included.
* Every cell phase 11 of chip_smoke.py runs is one the dry run knows,
  and its placed MoE prefill card cell (batch 1) is predicted to fit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parallel_worker import MOE_PLACED, moe_inputs, moe_layer  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
GB = 1e9


def _env():
    path = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    return {**os.environ, "PYTHONPATH": path, "JAX_PLATFORMS": "cpu"}


def _reference(arch, shape, opts, tmp_path):
    """The reference's dry run of one cell on 16x16, in its own process."""
    out = tmp_path / "ref.json"
    cmd = [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch, "--shape", shape,
           "--out", str(out)] + (["--opt", ",".join(opts)] if opts else [])
    proc = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


PREFILL = [("qwen3-moe-30b-a3b", ()), ("qwen3-moe-30b-a3b", ("moe_ep",)),
           ("moonshot-v1-16b-a3b", ())]


@pytest.mark.parametrize("arch,opts", PREFILL)
def test_moe_prefill_against_the_reference(arch, opts, tmp_path):
    ref = _reference(arch, "prefill_32k", opts, tmp_path)
    got = dryrun.run_cell(arch, "prefill_32k", False, verbose=False, opts=opts)
    assert got["fits_h100"], got["peak_memory_bytes"]
    assert 0.8 <= got["flops"] / ref["hlo_flops"] <= 1.25, (got["flops"], ref["hlo_flops"])
    assert got["peak_memory_bytes"] <= 1.5 * ref["peak_memory_bytes"], (
        got["peak_memory_bytes"], ref["peak_memory_bytes"])


# per-device peak of each cell while the slab was built whole on every device
REPLICATED_SLAB_PEAK = {"qwen3-moe-30b-a3b": 173.74 * GB, "moonshot-v1-16b-a3b": 174.34 * GB}


@pytest.mark.parametrize("arch", sorted(REPLICATED_SLAB_PEAK))
def test_moe_train_against_the_reference(arch, tmp_path):
    ref = _reference(arch, "train_4k", (), tmp_path)
    got = dryrun.run_cell(arch, "train_4k", False, verbose=False)
    assert got["flops"] <= ref["hlo_flops"], (got["flops"], ref["hlo_flops"])
    assert got["peak_memory_bytes"] < REPLICATED_SLAB_PEAK[arch], got["peak_memory_bytes"]
    assert got["fits_h100"]


def test_dense_cell_is_unchanged():
    got = dryrun.run_cell("deepseek-7b", "prefill_32k", False, verbose=False)
    assert (got["flops"], got["peak_memory_bytes"]) == (115772022063104.0, 5352652800.0)


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_gloo")
    for world in (4, 6):
        proc = subprocess.run(
            [sys.executable, str(ROOT / "tests" / "_torch_parallel_worker.py"), "moe_placed",
             str(world), str(out)], cwd=ROOT, env=_env(), capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
    return out


@pytest.mark.parametrize("case", list(MOE_PLACED))
def test_placed_moe_equals_whole_tensors(placed, case):
    arch, _mesh, batch, _flags, overrides = MOE_PLACED[case]
    got = np.load(placed / f"moe_{case.replace('/', '__')}.npz")
    want = moe_layer(*moe_inputs(arch, batch, overrides))
    assert sorted(got.files) == sorted(want)
    for k, v in want.items():
        v = v.numpy()
        if k.startswith("route/"):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (case, k)
            continue
        err = np.abs(got[k].astype(np.float64) - v).max()
        assert err <= TOL * max(np.abs(v).max(), 1e-30), (case, k, err)
    if "drops" in case or overrides.get("capacity_factor", 1.0) < 1.0:
        assert not want["route/keep"].all(), case


@pytest.fixture(scope="module")
def chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_cells_are_dry_run_cells(chip_smoke):
    """Every cell that phase 11 of chip_smoke.py runs is one the dry run
    knows (an arch and one of its shapes), the MoE prefills among the dry
    run's; the card cells' options are the dry run's, and the placed MoE
    prefill cell, cut to batch 1 as on the card, is predicted to fit."""
    import dataclasses

    from _torch_parallel_worker import FakeGroup
    from repro_torch.configs import SHAPES, applicable_shapes, get_config, list_archs
    from repro_torch.launch import analysis
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model
    from repro_torch.parallel import opt_flags

    cells = [(a, s) for a, s in chip_smoke.DRYRUN_CELLS] + \
        [(c[0], c[1]) for c in chip_smoke.CARD_CELLS]
    for arch, shape in cells:
        assert arch in list_archs() and shape in applicable_shapes(get_config(arch)), (arch, shape)
    assert {("qwen3-moe-30b-a3b", "prefill_32k"), ("moonshot-v1-16b-a3b", "prefill_32k")} \
        <= set(chip_smoke.DRYRUN_CELLS)
    for arch, shape, batch, layers, opts, per_step, note in chip_smoke.CARD_CELLS:
        assert set(opts) <= {"sp", "mamba_heads", "moe_ep", "sp_sub", "moe_a2a"}, opts
        assert batch is None or batch <= SHAPES[shape].global_batch
    (arch, shape, batch, layers, opts, per_step, _), = [
        c for c in chip_smoke.CARD_CELLS if c[:2] == ("qwen3-moe-30b-a3b", "prefill_32k")]
    assert "moe_a2a" not in opts and per_step == {"rmsnorm": 193,
                                                  "flash/mma_prefill K=128 causal": 48}
    cfg = get_config(arch)
    cell = dataclasses.replace(SHAPES[shape], global_batch=batch)
    with FakeGroup(1):
        mesh = make_debug_mesh(1, 1)
        model = Model(cfg, device="meta")
        dryrun.set_opts(model, cell, mesh, opts)
        try:
            got = dryrun.measure(model, cell, mesh)
        finally:
            opt_flags.reset()
    assert got["mode"].peak_bytes <= analysis.HBM_CAPACITY_BYTES, got["mode"].peak_bytes
    assert got["mode"].kernel_calls == {"rmsnorm": 193, "flash_attention": 48}
