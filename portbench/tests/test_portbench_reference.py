"""The plain reference agrees with the port at a reduced size in float32 on
the CPU, serving and training, dense and with experts (capacity drops
included); and it imports nothing of the program."""
import ast
import json
from pathlib import Path

import pytest
import torch

from portbench import program, weights
from portbench.bench import Bench
from portbench.reference import model as R

from .conftest import ROOT, TINY

SEED = 2_718_281_828


def f32(name):
    cfg = json.loads((TINY / f"{name}.json").read_text())
    return dict(cfg, torch_dtype="float32", reduced=cfg["reduced"] + ["torch_dtype"])


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_served_logits_match_the_ports_prefill_and_decode(name):
    from repro_torch.models import Model

    torch.manual_seed(0)
    cfg = f32(name)
    params = weights.draw(cfg, SEED, "cpu")
    model = Model(program.arch(cfg), "cpu")
    program.check_layout(model, params)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg["vocab_size"], (1, 37), generator=gen)
    cache = model.init_cache(1, 64)
    logits, cache = model.prefill(params, {"tokens": prompt.int()}, cache)
    got = [logits[0, 0]]
    served = [int(got[0].argmax())]
    for pos in range(37, 41):  # three fed tokens, each decoded through the cache
        lg, cache = model.decode_step(params, cache, torch.tensor([[served[-1]]], dtype=torch.int32), pos)
        got.append(lg[0, 0])
        served.append(int(lg[0, 0].argmax()))
    want = R.served_logits(cfg, params, [(prompt[0].tolist(), served)], batch_rows=8)[0]
    V = cfg["vocab_size"]
    torch.testing.assert_close(torch.stack(got)[:, :V], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_three_training_steps_match_the_ports(name):
    from repro_torch.models import Model
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import TrainState, make_train_step

    cfg = f32(name)
    mix = json.loads((TINY / "tiny_train.json").read_text())
    kind = Bench(ROOT).kind(mix)
    params = weights.draw(cfg, SEED, "cpu")
    model = Model(program.arch(cfg), "cpu")
    opt = AdamWConfig(**mix["adamw"])
    state = TrainState(params, adamw_init(params), None)
    step = make_train_step(model, opt)
    feed = kind.feed(cfg, mix, SEED, "cpu")
    batches = [next(feed) for _ in range(3)]
    prog = {"loss": []}
    for i, b in enumerate(batches):
        state, metrics = step(state, b)
        prog["loss"].append(float(metrics["loss"]))
        if i == 0:
            prog["first_norm"] = float(metrics["grad_norm"])
            prog["first_grad"] = kind.norms(state.opt.m, 1 / (1 - opt.b1))
            prog["first_sketch"] = {k: weights.sketch(k, m / (1 - opt.b1))
                                    for k, m in weights.layer_slices(state.opt.m)}
    start = weights.draw(cfg, SEED, "cpu")
    prog["change"] = {k: float(torch.linalg.vector_norm(a - b)) for (k, a), (_, b) in
                      zip(weights.layer_slices(state.params), weights.layer_slices(start))}
    ref = R.train_three(cfg, lambda: weights.draw(cfg, SEED, "cpu"),
                        [(b["tokens"].long(), b["labels"].long()) for b in batches], mix["adamw"])
    gaps = kind.compare(prog, ref)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_norm_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4 and gaps["grad_diff"] < 1e-4, gaps
    assert gaps["change_gap"] < 1e-3, gaps


def test_capacity_drops_in_row_major_order():
    cfg = {"num_experts": 4, "num_experts_per_tok": 2, "capacity_factor": 1.25, "hidden_size": 2,
           "num_attention_heads": 1, "num_key_value_heads": 1, "rms_norm_eps": 1e-6}
    assert R.capacity(cfg, 40) == 32 and R.capacity(cfg, 4) == 8 and R.capacity(dict(cfg, num_experts=128), 8) == 8
    ref = R.Reference(dict(cfg, num_experts_per_tok=1, capacity_factor=0.01))
    x = torch.ones(10, 2)
    w = {"router": torch.tensor([[1.0, 0, 0, 0], [0, 0, 0, 0]]), "w_up": torch.ones(4, 2, 1),
         "w_gate": torch.ones(4, 2, 1), "w_down": torch.ones(4, 1, 2)}
    out, _ = ref.moe(x, w, [(0, 10, 8)])  # all ten pick expert 0; the first eight get a slot
    assert (out[:8] != 0).all() and (out[8:] == 0).all()


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level else [])
            assert not any(n.split(".")[0] in ("repro_torch", "repro", "jax", "jaxlib", "flax")
                           for n in names), (path, names)


def test_nothing_in_the_benchmark_imports_jax_or_the_jax_package():
    for path in Path(ROOT / "portbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            else:
                continue
            # compared by the whole top-level name: repro_torch is not repro
            assert not {n.split(".")[0] for n in names} & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, path
