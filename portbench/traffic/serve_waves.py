"""Traffic kind ``serve_waves``: closed waves of requests served to
completion by ``ServeEngine.generate``, one call a wave, greedy, no EOS.

Prompt and output lengths are log-normal (``median``, ``sigma``, clipped to
``[min, max]``).  Every wave holds the ``requests_per_wave`` quantile
midpoints of each distribution, paired and ordered once and for all
(``sizes``), with token ids drawn from the seed: so each wave, in every run,
does the same work, and the seed moves only the ids.  Set-up serves one
such wave (wave 0), so that every prompt length, the decode batch and the
allocator's blocks of the window are warm before it starts.

The window runs from the first wave to the end of the last wave that started
before ``--seconds`` ran out.  ``serve_tokens_per_s`` is the prompt and
generated tokens of its requests over its length.  After the window a
sample of its requests, drawn from the seed, with the longest prompt and the
longest answer in it and at least ``check_tokens`` served tokens, is run
through the plain reference.  A served token's gap is the amount by which
its logit lies below the reference's best at its position; compared are the
widest gap (``logit_gap``) and the mean gap (``logit_gap_mean``), which a
routing flip at a near tie moves less than the widest.
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench import program, weights
from portbench.bench import Outcome, Run, profiled
from portbench.reference.model import served_logits

SIZES_SEED = 20250101  # the one pairing and order of a wave's sizes


def lengths(spec: dict, n: int) -> List[int]:
    """The ``n`` quantile midpoints of a clipped log-normal, ascending."""
    z = statistics.NormalDist()
    return [int(round(min(max(spec["median"] * np.exp(spec["sigma"] * z.inv_cdf((i + 0.5) / n)),
                              spec["min"]), spec["max"]))) for i in range(n)]


def sizes(mix: dict) -> List[Tuple[int, int]]:
    """``(prompt length, output length)`` of a wave's requests, in the order
    served: the quantile midpoints, paired and ordered by one shuffle drawn
    from the fixed ``SIZES_SEED``.  The order sets how many decode steps the
    wave takes (rows free up as their requests end), so it is the same for
    every wave and every seed."""
    n = mix["requests_per_wave"]
    prompts, outputs = lengths(mix["prompt"], n), lengths(mix["output"], n)
    rng = np.random.default_rng(SIZES_SEED)
    pair, order = rng.permutation(n), rng.permutation(n)
    return [(prompts[i], outputs[pair[i]]) for i in order]


def wave(mix: dict, vocab: int, seed: int, index: int) -> List[Tuple[List[int], int]]:
    """Wave ``index`` (from 1): ``(prompt, output length)`` of each request,
    in the order served, its token ids drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    return [(rng.integers(0, vocab, size=p).tolist(), n) for p, n in sizes(mix)]


def warmup(mix: dict, vocab: int, seed: int) -> List[Tuple[List[int], int]]:
    """The warm-up: a whole wave (index 0), the window's sizes in its order."""
    return wave(mix, vocab, seed, 0)


def _serve(engine, reqs: Sequence[Tuple[List[int], int]], first_id: int) -> Dict[int, List[int]]:
    from repro_torch.serve.engine import Request

    return engine.generate([Request(first_id + i, p, max_new_tokens=n, temperature=0.0)
                            for i, (p, n) in enumerate(reqs)])


def sample(done: List[Tuple[List[int], List[int], int]], seed: int, tokens: int) -> List[int]:
    """Indices of the requests to check: the first with the longest prompt,
    the first with the longest answer, then others in an order drawn from
    the seed until ``tokens`` served tokens are in."""
    first = [max(range(len(done)), key=lambda i: len(done[i][0])),
             max(range(len(done)), key=lambda i: len(done[i][1]))]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1 << 30]))
    picked: List[int] = []
    for i in first + rng.permutation(len(done)).tolist():
        if i not in picked:
            picked.append(i)
        if sum(len(done[j][1]) for j in picked) >= tokens and len(picked) >= 2:
            break
    return picked


def gaps(logits: Sequence[torch.Tensor], chosen: Sequence[Sequence[int]]) -> torch.Tensor:
    """Each chosen token's gap: the best logit at its position less its own."""
    return torch.cat([lg.max(-1).values - lg.gather(1, torch.tensor(list(t), device=lg.device)[:, None])[:, 0]
                      for lg, t in zip(logits, chosen) if t])


def numbers(logits: Sequence[torch.Tensor], chosen: Sequence[Sequence[int]]) -> Dict[str, float]:
    """The numbers a cell's limits may hold: the widest gap of the chosen
    tokens (``logit_gap``) and their mean gap (``logit_gap_mean``)."""
    g = gaps(logits, chosen)
    return {"logit_gap": float(g.max()), "logit_gap_mean": float(g.mean())}


def run(run: Run) -> Outcome:
    from repro_torch.serve.engine import ServeEngine

    cfg, mix, dev = run.cfg, run.mix, run.device
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    params = weights.draw(cfg, run.seed, dev)
    engine = ServeEngine(program.arch(cfg), params, max_len=mix["max_len"], eos_id=None, seed=run.seed,
                         batch_size=mix["batch"], device=dev)
    program.check_layout(engine.model, params)
    _serve(engine, warmup(mix, cfg["vocab_size"], run.seed), -mix["requests_per_wave"])
    sync()
    setup_s = time.perf_counter() - run.t0
    run.log(f"set-up {setup_s:.3f} s")

    done: List[Tuple[List[int], List[int], int]] = []  # (prompt, generated, asked)
    calls: Dict[str, List[float]] = {"prefill": [], "decode": []}
    waves_s: List[float] = []
    start = time.perf_counter()
    index = 1
    while True:
        reqs = wave(mix, cfg["vocab_size"], run.seed, index)
        out = _serve(engine, reqs, len(done))
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
        reqs = wave(mix, cfg["vocab_size"], run.seed, index)
        _, trace, traced_s = profiled(lambda: _serve(engine, reqs, len(done)), cuda)
        records.update(traced_prompts=[len(p) for p, _ in reqs], traced_s=traced_s)
        run.log(f"traced wave {traced_s:.3f} s")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    picked = sample(done, run.seed, mix["check_tokens"])
    checked = [(done[i][0], done[i][1]) for i in picked]
    logits = served_logits(cfg, params, checked, batch_rows=mix["batch"])
    records["check"] = {"requests": checked, "logits": logits}
    run.log(f"checked {len(picked)} requests, {sum(len(g) for _, g in checked)} served tokens")
    return Outcome(
        attempted=len(done), failed=sum(len(g) != n for _, g, n in done),
        e2e={"setup_s": setup_s, "serve_tokens_per_s": served / window_s},
        compared=numbers(logits, [g for _, g in checked]), memory_peak_bytes=peak, records=records,
        trace=trace, traced_s=traced_s)
