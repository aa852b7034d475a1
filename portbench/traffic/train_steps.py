"""Traffic kind ``train_steps``: steps of the port's training step
(``make_train_step``: the loss and its gradients with every block
recomputed, then AdamW), each on a new batch of ``batch`` rows of ``seq``
tokens drawn uniformly from the published vocabulary on the device from the
seed.

Set-up builds the one training state from the benchmark's weights and drives
it through its first ``CHECKED`` steps, which warm every shape of the
window; the window then runs steps on that same state until ``--seconds``
have passed, each to a synchronised end.  ``train_tokens_per_s`` is the
tokens of its steps over its length.

The plain reference follows the first ``CHECKED`` steps from the same
weights and batches in float32.  Compared: each step's loss
(``loss_gap``, the widest absolute gap); the norm of each layer's first
gradient as the optimizer takes it, read from the program's first moment
after one step (``grad_gap``); the norm of each layer's change after the
``CHECKED`` steps (``change_gap``).  The last two by the worst layer slice:
the gap between the two norms over the reference's norm of that slice or of
the median slice, whichever is larger.  Slices whose reference gradient is
under a thousandth of the median slice's are left out of the change.  And
``grad_diff``: the median slice's distance between the two first gradients
(estimated from their projections on random directions, ``weights.sketch``),
over the same norm: the norms move with an error in the second order, the
distance in the first.  The numbers above are taken after clipping, which
hides a gradient's scale (a loss over the wrong count of tokens); so also
``grad_norm_gap``: the gap between the program's global gradient norm
before clipping on the first step (the ``grad_norm`` the step reports) and
the reference's, over the reference's.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from portbench import program, weights
from portbench.bench import Outcome, Run, profiled
from portbench.reference.model import train_three

CHECKED = 3  # steps the reference follows
TRACED = 3  # steps under the profiler
QUIET = 1e-3  # a slice whose reference gradient is under this share of the median's


def feed(cfg: dict, mix: dict, seed: int, device) -> Iterator[Dict[str, torch.Tensor]]:
    """The steps' batches, in order."""
    state = np.random.SeedSequence([seed, 2]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device).manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
    while True:
        t = torch.randint(0, cfg["vocab_size"], (mix["batch"], mix["seq"] + 1), generator=gen, device=device)
        yield {"tokens": t[:, :-1].int().contiguous(), "labels": t[:, 1:].int().contiguous()}


def norms(tree, scale: float = 1.0) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.float())) * scale for k, t in weights.layer_slices(tree)}


def _worst(prog: Dict[str, float], ref: Dict[str, float], keys=None) -> float:
    keys = list(ref) if keys is None else keys
    floor = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keys)


def diffs(prog: dict, ref: dict) -> Dict[str, float]:
    """Each slice's first gradient's distance from the reference's,
    estimated from the two sketches, over the reference's norm of that
    slice or of the median slice, whichever is larger."""
    floor = statistics.median(ref["first_grad"].values())
    return {k: float(torch.linalg.vector_norm(prog["first_sketch"][k] - s)) / weights.SKETCH ** 0.5
            / max(ref["first_grad"][k], floor) for k, s in ref["first_sketch"].items()}


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers a cell's limits may hold, of ``prog`` against ``ref``
    (each ``{"loss": [...], "first_norm": norm before clipping,
    "first_grad": {slice: norm}, "first_sketch": {slice: projections},
    "change": {slice: norm}}``)."""
    floor = statistics.median(ref["first_grad"].values())
    moving = [k for k, g in ref["first_grad"].items() if g >= QUIET * floor]
    return {"loss_gap": max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"])),
            "grad_norm_gap": abs(prog["first_norm"] - ref["first_norm"]) / ref["first_norm"],
            "grad_gap": _worst(prog["first_grad"], ref["first_grad"]),
            "grad_diff": statistics.median(diffs(prog, ref).values()),
            "change_gap": _worst(prog["change"], ref["change"], moving)}


def run(run: Run) -> Outcome:
    from repro_torch.models import Model
    from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
    from repro_torch.train.train_step import TrainState, loss_and_grads, make_train_step

    cfg, mix, dev = run.cfg, run.mix, run.device
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    model = Model(program.arch(cfg), dev)
    params = weights.draw(cfg, run.seed, dev)
    program.check_layout(model, params)
    opt = AdamWConfig(**mix["adamw"])
    state = TrainState(params=params, opt=adamw_init(params), error_feedback=None)
    del params
    step = make_train_step(model, opt)
    batches = feed(cfg, mix, run.seed, dev)
    prog: dict = {"loss": []}
    for k in range(CHECKED):
        state, metrics = step(state, next(batches))
        prog["loss"].append(float(metrics["loss"]))
        if k == 0:  # the first moment after one step is (1 - b1) times the clipped gradient
            prog["first_norm"] = float(metrics["grad_norm"])
            prog["first_grad"] = norms(state.opt.m, 1.0 / (1.0 - opt.b1))
            prog["first_sketch"] = {name: weights.sketch(name, m / (1.0 - opt.b1))
                                    for name, m in weights.layer_slices(state.opt.m)}
    start = weights.draw(cfg, run.seed, dev)
    prog["change"] = {k: float(torch.linalg.vector_norm(a.float() - b.float())) for (k, a), (_, b) in
                      zip(weights.layer_slices(state.params), weights.layer_slices(start))}
    del start
    sync()
    setup_s = time.perf_counter() - run.t0
    run.log(f"set-up {setup_s:.3f} s; losses {prog['loss']}, first gradient norm {prog['first_norm']}")

    steps, bad = 0, 0
    begin = time.perf_counter()
    while True:
        state, metrics = step(state, next(batches))
        steps += 1
        bad += not math.isfinite(float(metrics["loss"]))  # waits for the step's end
        if time.perf_counter() - begin >= run.seconds:
            break
    window_s = time.perf_counter() - begin
    tokens = steps * mix["batch"] * mix["seq"]
    run.log(f"window {window_s:.3f} s: {steps} steps, {tokens} tokens")

    records = {"window_s": window_s, "steps": steps, "batch": mix["batch"], "seq": mix["seq"]}
    trace: Optional[object] = None
    traced_s = 0.0
    if run.trace:
        batch = next(batches)
        sync()
        t0 = time.perf_counter()
        _, _, grads = loss_and_grads(model, state.params, batch)
        sync()
        t1 = time.perf_counter()
        adamw_update(opt, state.params, grads, state.opt)
        sync()
        records.update(loss_and_grads_ms=(t1 - t0) * 1e3, adamw_ms=(time.perf_counter() - t1) * 1e3)
        del grads, batch
        held = [state]

        def traced():
            for _ in range(TRACED):
                held[0], _ = step(held[0], next(batches))

        _, trace, traced_s = profiled(traced, cuda)
        records.update(traced_steps=TRACED, traced_s=traced_s)
        state = held.pop()
        run.log(f"traced {TRACED} steps {traced_s:.3f} s")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del state, step, model, metrics
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    again = feed(cfg, mix, run.seed, dev)
    ref = train_three(cfg, lambda: weights.draw(cfg, run.seed, dev),
                      [(b["tokens"].long(), b["labels"].long()) for b in (next(again) for _ in range(CHECKED))],
                      mix["adamw"])
    compared = compare(prog, ref)
    records["check"] = {"program": prog, "reference": ref}
    run.log(f"reference losses {ref['loss']}")
    return Outcome(attempted=steps, failed=bad,
                   e2e={"setup_s": setup_s, "train_tokens_per_s": tokens / window_s},
                   compared=compared, memory_peak_bytes=peak, records=records,
                   trace=trace, traced_s=traced_s)
