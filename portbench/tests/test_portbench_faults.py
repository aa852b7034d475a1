"""A run at a test size on the CPU, the look for a chip skipped: sound, it is
correct; with the timed path broken underneath, or with the control in the
program's place, it is not."""
import itertools
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench.bench import Bench, Run, run_cell

from .conftest import ROOT, TINY_CELLS

SEED = 2_147_483_659  # a little over 2**31


def run(root, cell, trace=False):
    b = Bench(root)
    c = b.cell(cell)
    return run_cell(Run(b, c, b.config(c), b.mix(c), SEED, 0.3, trace, "cpu", time.perf_counter()))


@pytest.mark.parametrize("cell", list(TINY_CELLS))
def test_a_sound_run_is_correct(tiny_root, cell):
    line = run(tiny_root, cell)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0, line
    assert list(line)[-1] == "compared" and list(line["compared"]) == list(json.loads(
        (tiny_root / "portbench" / "limits" / f"{cell}.json").read_text()))
    assert set(line["metrics"]) == {"setup_s", "serve_tokens_per_s" if "serve" in cell else "train_tokens_per_s"}


def test_a_traced_run_reports_the_per_layer_metrics_it_finds(tiny_root):
    line = run(tiny_root, "tiny-dense.tiny_train", trace=True)
    assert line["correct"]
    # on the CPU no device operation is traced: the device's metrics are left out, not 0
    assert set(line["metrics"]) == {"loss_and_grads_ms.train", "adamw_ms.train", "mfu.train"}
    assert line["device"]["busy_s"] == 0.0 and line["device"]["window_s"] > 0


def _token_altered(monkeypatch, vocab):
    from repro_torch.serve.engine import ServeEngine

    orig, n = ServeEngine._sample, itertools.count()
    monkeypatch.setattr(ServeEngine, "_sample",
                        lambda self, lg, t: (orig(self, lg, t) + (next(n) % 3 == 2)) % vocab)


def _decode_state_unchanged(monkeypatch, vocab):
    from repro_torch.models.model import Model
    from repro_torch.tree import tree_map

    orig = Model.decode_step

    def stale(self, params, cache, tokens, pos):
        logits, _ = orig(self, params, tree_map(torch.clone, cache), tokens, pos)
        return logits, cache

    monkeypatch.setattr(Model, "decode_step", stale)


def _decode_half_the_batch(monkeypatch, vocab):
    from repro_torch.models.model import Model

    orig = Model.decode_step

    def half(self, params, cache, tokens, pos):
        logits, cache = orig(self, params, cache, tokens, pos)
        keep = max(1, logits.shape[0] // 2)
        return logits[:keep].repeat((logits.shape[0] + keep - 1) // keep, 1, 1)[:logits.shape[0]], cache

    monkeypatch.setattr(Model, "decode_step", half)


def _step_state_unchanged(monkeypatch, vocab):
    from repro_torch.train import train_step

    def unchanged(cfg, params, grads, state):
        return params, state, {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}

    monkeypatch.setattr(train_step, "adamw_update", unchanged)


def _step_half_the_batch(monkeypatch, vocab):
    from repro_torch.train import train_step

    orig = train_step.loss_and_grads

    def half(model, params, batch):
        return orig(model, params, {k: v[: v.shape[0] // 2] for k, v in batch.items()})

    monkeypatch.setattr(train_step, "loss_and_grads", half)


def _step_gradient_scaled(monkeypatch, vocab):
    """A loss taken over the wrong count of tokens: every gradient twice what
    it should be, which clipping hides from the numbers taken after it."""
    from repro_torch.train import train_step
    from repro_torch.tree import tree_map

    orig = train_step.loss_and_grads

    def doubled(model, params, batch):
        loss, metrics, grads = orig(model, params, batch)
        return loss, metrics, tree_map(lambda g: g * 2, grads)

    monkeypatch.setattr(train_step, "loss_and_grads", doubled)


SERVE_FAULTS = [_token_altered, _decode_state_unchanged, _decode_half_the_batch]
TRAIN_FAULTS = [_step_state_unchanged, _step_half_the_batch, _step_gradient_scaled]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in TINY_CELLS
                                        for f in (SERVE_FAULTS if "serve" in c else TRAIN_FAULTS)],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    b = Bench(tiny_root)
    fault(monkeypatch, b.config(b.cell(cell))["vocab_size"])
    line = run(tiny_root, cell)
    assert not line["correct"], line["compared"]


# At the test size the expert model's routing choices that flip at near ties
# between bfloat16 and float32 outweigh float8's rounding (the control reads
# below the sound program there), so the control is held on the dense cells.
@pytest.mark.parametrize("cell", ["tiny-dense.tiny_serve", "tiny-dense.tiny_train"])
def test_the_control_fails_a_limit(tiny_root, cell):
    """The reference in float8 in the program's place, and the faults the
    calibration reads, each against the float32 reference of a sound run."""
    from portbench import calibrate

    b = Bench(tiny_root)
    c = b.cell(cell)
    cfg, mix, limits = b.config(c), b.mix(c), b.limits(c)
    kind = b.kind(mix)
    out = kind.run(Run(b, c, cfg, mix, SEED, 0.3, False, "cpu", time.perf_counter()))
    faults = (calibrate.serve_faults if "serve" in cell else calibrate.train_faults)(kind, cfg, mix, out, SEED, "cpu")
    for name, got in faults.items():
        if not name.endswith("detail"):
            assert any(got[k] > lim["limit"] for k, lim in limits.items()), (name, got)


def test_run_exits_without_a_card_or_the_program(tmp_path):
    """Without CUDA devices (here), and in a directory that holds only the
    benchmark's files, the command exits non-zero and prints no result."""
    cmd = [sys.executable, "portbench/run.py", "--workload", "deepseek-7b.serve_longdoc", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for cwd in (ROOT, tmp_path):
        p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=300)
        if torch.cuda.is_available() and cwd == ROOT:
            continue
        assert p.returncode != 0 and p.stdout.strip() == "", (cwd, p.stdout, p.stderr[-2000:])
