"""The readings a cell's limits are set from, on the chip at the cell's own
size (the benchmark's own runs do not run this).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3 [--seconds 1]

For every seed, one run of the cell with a short window (one wave, or the
first steps and one more), and the numbers it compares: the sound
program's readings, whose largest is a limit's lower reading.  For each
control seed, in the same process, the same numbers of the control (the
reference computed in float8 e4m3, the precision below the configuration's
bfloat16, in the program's place) and of the faults a cell can have, each
against the float32 reference of that run:

* serving: ``token`` (each checked request's first served token altered
  where it is produced);
* training: ``half`` (each step's loss and gradients over the first half of
  its batch), and ``unchanged`` (a step that returns its state unchanged:
  its first moment and every layer's change are 0, so ``grad_gap`` and
  ``change_gap`` read 1 without a run).

Prints one JSON line a reading, then a summary line; writes them to
``chiprun_out/calibrate_<cell>.json`` when that directory exists.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def serve_faults(kind, cfg, mix, out, seed, device):
    from portbench import weights
    from portbench.reference.model import served_logits

    check = out.records["check"]
    reqs, ref = check["requests"], check["logits"]
    control = served_logits(cfg, weights.draw(cfg, seed, device), reqs, prec="fp8", batch_rows=mix["batch"])
    picks = [lg.argmax(-1).tolist() for lg in control]
    altered = [[(g[0] + 1) % cfg["vocab_size"]] + list(g[1:]) for _, g in reqs]
    return {"control": kind.numbers(ref, picks), "token": kind.numbers(ref, altered),
            "control_detail": _spread(kind, ref, picks)}


def _spread(kind, logits, chosen):
    """Each served token's gap, summed up: how many, how many above 0, the
    mean, the 90th percentile and the widest."""
    gaps = kind.gaps(logits, chosen)
    return {"tokens": gaps.numel(), "above_0": int((gaps > 0).sum()), "mean": float(gaps.mean()),
            "p90": float(gaps.quantile(0.9)), "max": float(gaps.max())}


def train_faults(kind, cfg, mix, out, seed, device):
    from portbench import weights
    from portbench.reference.model import train_three

    ref = out.records["check"]["reference"]

    def batches():
        again = kind.feed(cfg, mix, seed, device)
        return [(b["tokens"].long(), b["labels"].long()) for b in (next(again) for _ in range(kind.CHECKED))]

    draw = lambda: weights.draw(cfg, seed, device)  # noqa: E731
    control = train_three(cfg, draw, batches(), mix["adamw"], prec="fp8")
    half = train_three(cfg, draw, batches(), mix["adamw"], rows=mix["batch"] // 2)
    unchanged = dict(ref, first_grad={k: 0.0 for k in ref["first_grad"]}, change={k: 0.0 for k in ref["change"]},
                     first_sketch={k: 0.0 * v for k, v in ref["first_sketch"].items()})
    readings = {name: kind.compare(r, ref) for name, r in
                (("control", control), ("half", half), ("unchanged", unchanged))}
    readings.update(control_detail=_by_slice(kind, control, ref), half_detail=_by_slice(kind, half, ref))
    return readings


def detail(kind, out):
    """Where the program's reading of a run comes from."""
    check = out.records["check"]
    if "logits" in check:
        return _spread(kind, check["logits"], [g for _, g in check["requests"]])
    return _by_slice(kind, check["program"], check["reference"])


def _by_slice(kind, r, ref):
    """Where a training reading comes from: each step's loss gap, and the
    worst and the median slice of the first gradient's and the change's
    gaps and of the first gradient's distance."""
    import statistics

    def spread(g):
        worst = max(g, key=g.get)
        return {"worst": worst, "worst_gap": g[worst], "median_gap": statistics.median(g.values())}

    def gaps(key):
        floor = statistics.median(ref[key].values())
        return spread({k: abs(r[key][k] - ref[key][k]) / max(ref[key][k], floor) for k in ref[key]})

    diffs = kind.diffs(r, ref)
    return {"loss": [a - b for a, b in zip(r["loss"], ref["loss"])], "grad": gaps("first_grad"),
            "diff": spread(diffs), "change": gaps("change"), "diffs": diffs}


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds of the sound program")
    p.add_argument("--control-seeds", default="", help="comma-separated seeds of the control and the faults")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import bench

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    b = bench.Bench()
    cell = b.cell(args.workload)
    cfg, mix = b.config(cell), b.mix(cell)
    kind = b.kind(mix)
    faults = train_faults if mix["kind"] == "train_steps" else serve_faults
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        run = bench.Run(b, cell, cfg, mix, seed, args.seconds, False, "cuda", time.perf_counter())
        out = kind.run(run)
        line = {"seed": seed, "program": out.compared, "e2e": out.e2e, "detail": detail(kind, out)}
        if seed in controls:
            line.update(faults(kind, cfg, mix, out, seed, "cuda"))
        del out
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        lines.append(line)
    summary = {"workload": cell["name"], "card": bench._power_limit(), "seconds": time.perf_counter() - T0}
    for name in lines[0]["program"]:
        summary[name] = {"lower": max(x["program"][name] for x in lines)}
        for f in ("control", "token", "half", "unchanged"):
            got = [x[f][name] for x in lines if f in x]
            if got:
                summary[name][f] = min(got)
    print(json.dumps(summary), flush=True)
    out_dir = ROOT / "chiprun_out"
    if out_dir.is_dir():
        (out_dir / f"calibrate_{cell['name']}.json").write_text("\n".join(map(json.dumps, lines + [summary])))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
