"""The readings the limits of a ``serve_waves_routed`` cell are set from, on
the chip at the cell's own size (the benchmark's own runs do not run this):
``calibrate.py``'s serve path with the reference that follows the
program's recorded routing (``reference/routed.py``).

    python3 portbench/calibrate_routed.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3 [--seconds 1]

For every seed, one run of the cell with a short window (one wave), and the
numbers it compares: the sound program's readings.  For each control seed,
in the same process:

* ``control``: the reference in float8 e4m3 (the precision below the
  configuration's bfloat16) in the program's place, with its own routing
  choices: its served tokens against the float32 reference that follows
  its choices, as the check follows the program's;
* ``token``: each checked request's first served token altered;
* ``route``: at the middle layer, each checked token's K-th expert swapped
  for the next most probable (the program's K+1-th where the reference
  agrees with it), every slot re-derived, the served tokens as they were.

Prints one JSON line a reading, then a summary line.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FAULTS = ("control", "token", "route")


def faults(kind, cfg, mix, out, seed, device):
    from portbench import weights
    from portbench.calibrate import _spread
    from portbench.reference import routed

    check = out.records["check"]
    checked, calls, ref = check["checked"], check["calls"], check["logits"]
    params = weights.draw(cfg, seed, device)

    def numbers(logits, chosen, pinned, routing):
        got = kind.numbers(logits, chosen)
        got.update(route_margin=float(pinned.margin), keep_mismatch=routed.keep_mismatch(cfg, routing))
        return got

    control, own = routed.served_logits(cfg, params, checked, calls, prec="fp8", follow="own")
    picks = [lg.argmax(-1).tolist() for lg in control]
    mine = routed.with_choices(cfg, checked, calls, own.chosen)
    del control, own
    ref_c, pinned = routed.served_logits(cfg, params, checked, mine)
    got = {"control": numbers(ref_c, picks, pinned, mine)}
    altered = [[(g[0] + 1) % cfg["vocab_size"]] + list(g[1:]) for _, _, g in checked]
    got["token"] = dict(out.compared, **kind.numbers(ref, altered))
    swapped, pinned = routed.served_logits(cfg, params, checked, calls, swap_layer=cfg["num_hidden_layers"] // 2)
    got["route"] = numbers(swapped, [g for _, _, g in checked], pinned,
                           routed.with_choices(cfg, checked, calls, pinned.chosen))
    got["control_detail"] = _spread(kind, ref_c, picks)
    return got


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds of the sound program")
    p.add_argument("--control-seeds", default="", help="comma-separated seeds of the control and the faults")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import bench, calibrate

    if not torch.cuda.is_available():
        print("calibrate_routed: no CUDA device", file=sys.stderr)
        return 1
    b = bench.Bench()
    cell = b.cell(args.workload)
    cfg, mix = b.config(cell), b.mix(cell)
    if mix["kind"] != "serve_waves_routed":
        print(f"calibrate_routed: {cell['name']} is of kind {mix['kind']}: use calibrate.py", file=sys.stderr)
        return 1
    kind = b.kind(mix)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        torch.cuda.reset_peak_memory_stats()
        run = bench.Run(b, cell, cfg, mix, seed, args.seconds, False, "cuda", time.perf_counter())
        out = kind.run(run)
        check = out.records["check"]
        line = {"seed": seed, "program": out.compared, "e2e": out.e2e, "peak_bytes": out.memory_peak_bytes,
                "detail": calibrate.detail(kind, out),
                "routing": kind.dropped(check["calls"])}
        if seed in controls:
            line.update(faults(kind, cfg, mix, out, seed, "cuda"))
        del out, check
        torch.cuda.empty_cache()
        print(json.dumps(line), flush=True)
        lines.append(line)
    summary = {"workload": cell["name"], "card": bench._power_limit(), "seconds": time.perf_counter() - T0}
    for name in lines[0]["program"]:
        summary[name] = {"lower": max(x["program"][name] for x in lines)}
        for f in FAULTS:
            got = [x[f][name] for x in lines if f in x]
            if got:
                summary[name][f] = min(got)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
