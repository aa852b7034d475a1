"""Traffic kind ``serve_waves_routed``: ``serve_waves``' closed waves, set-up,
window and records as they are, checked against a reference that follows
the program's recorded routing (``reference/routed.py``).

It is the kind of a mixture-of-experts model served at a decode batch whose
calls can drop pairs (an expert's slots for a call of that many rows fewer
than the rows): which pairs a decode call drops depends on what every row
of the call chose, and in bfloat16 a few routing choices flip at near ties
against float32.  So the program's routing is read out through the timed
window (``repro_torch.models.moe.record_routing``; the engine tags each
model call with the request of each row), only the newest wave's records
kept.  After the window, requests of the last timed wave, as
``serve_waves.sample`` draws them (the longest prompt first), until
``check_tokens`` served tokens are in, go through the reference, which
follows the program's expert choices and re-derives each pair's slot from
its whole call.  Compared: ``logit_gap`` and ``logit_gap_mean`` as in
``serve_waves``, ``route_margin`` and ``keep_mismatch``.

The engine decodes from CUDA graphs (``ServeEngine``'s ``cuda_graphs``),
as a deployment of the model serves it: eagerly, the host's launches of 48
expert layers set each decode step's pace, and the step's time follows
whatever else the host is doing.  Its prefills run eagerly, as in
``serve_waves``.

A program that reads out no routing fails at once, before any weight is
drawn.
"""
from __future__ import annotations

import gc
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

from portbench import program, weights
from portbench.bench import Outcome, Run, _load, profiled
from portbench.reference import routed

waves = _load(Path(__file__).with_name("serve_waves.py"))
gaps, numbers = waves.gaps, waves.numbers  # as serve_waves compares, for calibrate.py's readers


def calls_of(records: Sequence, layers: int) -> List[Dict]:
    """The program's routing records as the reference takes them: one dict
    a model call, in the order made, each with one entry a layer."""
    calls: Dict[int, Dict] = {}
    for x in records:
        c = calls.setdefault(x.call, {"kind": x.kind, "rows": list(x.rows), "top_i": [], "slot": [], "keep": []})
        if x.layer != len(c["top_i"]):
            raise ValueError(f"call {x.call}: routing call {x.layer} recorded as the {len(c['top_i'])}th")
        c["top_i"].append(x.top_i)
        c["slot"].append(x.slot)
        c["keep"].append(x.keep)
    if any(len(c["top_i"]) != layers for c in calls.values()):
        raise ValueError(f"a model call recorded other than {layers} routing calls")
    return [calls[k] for k in sorted(calls)]


def dropped(calls: Sequence[Dict]) -> Dict[str, List[int]]:
    """``[pairs, dropped pairs]`` of the calls, by kind."""
    out: Dict[str, List] = {}
    for c in calls:
        n = out.setdefault(c["kind"], [0, torch.zeros((), dtype=torch.int64, device=c["keep"][0].device)])
        n[0] += sum(k.numel() for k in c["keep"])
        n[1] = n[1] + sum((~k).sum() for k in c["keep"])
    return {k: [a, int(b)] for k, (a, b) in out.items()}


def layers() -> Dict[str, Dict[str, float]]:
    """The expert layers of the traced wave, from the program's ``moe.route``
    spans, by the engine call they ran in: layers, pairs, pairs kept, the
    mean live experts and the mean and greatest ``max_load`` of a layer;
    empty where the program recorded no such span."""
    try:
        from repro_torch.spans import session
    except ImportError:
        return {}
    got = session()
    calls = [(s.start, s.end, s.name[6:]) for s in got if s.name in ("serve.prefill", "serve.decode")]
    out: Dict[str, Dict[str, float]] = {}
    for s in got:
        if s.name != "moe.route" or "kept" not in s.attrs:
            continue
        kind = next((k for a, b, k in calls if a <= s.start and b is not None and s.end <= b), "other")
        n = out.setdefault(kind, {"layers": 0, "pairs": 0, "kept": [], "live": [], "max_load": []})
        n["layers"] += 1
        n["pairs"] += s.attrs["pairs"]
        for k in ("kept", "live", "max_load"):
            n[k].append(s.attrs[k])
    for n in out.values():
        kept, live, most = (torch.stack(n[k]).double() for k in ("kept", "live", "max_load"))
        n.update(kept=int(kept.sum()), live=float(live.mean()), max_load=float(most.mean()),
                 max_load_top=int(most.max()))
    return out


def check(cfg: dict, params: Dict, checked: Sequence[routed.Checked], calls: Sequence[Dict]):
    """The reference's logits of the checked requests and the numbers a
    cell's limits may hold."""
    logits, ref = routed.served_logits(cfg, params, checked, calls)
    got = numbers(logits, [g for _, _, g in checked])
    got.update(route_margin=float(ref.margin), keep_mismatch=routed.keep_mismatch(cfg, calls))
    return logits, got


def run(run: Run) -> Outcome:
    from repro_torch.models import moe
    from repro_torch.serve.engine import ServeEngine

    if not hasattr(moe, "record_routing"):
        raise RuntimeError("the program reads out no routing (repro_torch.models.moe.record_routing), "
                           "which this cell's check follows")
    cfg, mix, dev = run.cfg, run.mix, run.device
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    params = weights.draw(cfg, run.seed, dev)
    engine = ServeEngine(program.arch(cfg), params, max_len=mix["max_len"], eos_id=None, seed=run.seed,
                         batch_size=mix["batch"], device=dev, cuda_graphs=True)
    program.check_layout(engine.model, params)
    waves._serve(engine, waves.warmup(mix, cfg["vocab_size"], run.seed), -mix["requests_per_wave"])
    sync()
    setup_s = time.perf_counter() - run.t0
    run.log(f"set-up {setup_s:.3f} s")

    done: List[Tuple[List[int], List[int], int]] = []  # (prompt, generated, asked)
    calls: Dict[str, List[float]] = {"prefill": [], "decode": []}
    waves_s: List[float] = []
    start = time.perf_counter()
    index = 1
    with moe.record_routing() as rec:
        while True:
            rec.clear()  # the newest wave's records alone
            last = len(done)
            reqs = waves.wave(mix, cfg["vocab_size"], run.seed, index)
            out = waves._serve(engine, reqs, len(done))
            done += [(p, out[len(done) + i], n) for i, (p, n) in enumerate(reqs)]
            for k in calls:
                calls[k] += engine.call_seconds[k]
            index += 1
            waves_s.append(time.perf_counter() - start - sum(waves_s))
            if time.perf_counter() - start >= run.seconds:
                break
    window_s = time.perf_counter() - start
    run.log("waves (s):", " ".join(f"{w:.4f}" for w in waves_s))
    served = sum(len(p) + len(g) for p, g, _ in done)
    run.log(f"window {window_s:.3f} s: {index - 1} waves, {len(done)} requests, {served} tokens")

    records = {"prefill_s": calls["prefill"], "decode_s": calls["decode"], "window_s": window_s,
               "requests": [(len(p), len(g)) for p, g, _ in done]}
    trace, traced_s = None, 0.0
    if run.trace:
        reqs = waves.wave(mix, cfg["vocab_size"], run.seed, index)
        _, trace, traced_s = profiled(lambda: waves._serve(engine, reqs, len(done)), cuda)
        records.update(traced_prompts=[len(p) for p, _ in reqs], traced_s=traced_s)
        run.log(f"traced wave {traced_s:.3f} s; its expert layers:", layers())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    routing = calls_of(rec.records, cfg["num_hidden_layers"])
    run.log("last wave's routing, [pairs, dropped] by kind:", dropped(routing))
    picked = waves.sample(done[last:], run.seed, mix["check_tokens"])
    checked = [(last + i, done[last + i][0], done[last + i][1]) for i in picked]
    logits, compared = check(cfg, params, checked, routing)
    records["check"] = {"requests": [(p, g) for _, p, g in checked], "checked": checked, "logits": logits,
                        "calls": routing}
    run.log(f"checked {len(picked)} requests, {sum(len(g) for _, _, g in checked)} served tokens")
    return Outcome(
        attempted=len(done), failed=sum(len(g) != n for _, g, n in done),
        e2e={"setup_s": setup_s, "serve_tokens_per_s": served / window_s},
        compared=compared, memory_peak_bytes=peak, records=records, trace=trace, traced_s=traced_s)
