"""The benchmark of the port on one H100: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds the cell's program (``repro_torch``,
from ``src/``), warms it up, measures the window, checks what the timed path
produced against the plain reference, and prints one JSON object as the last
line of its standard output.  It exits non-zero, and prints no result, where
the cell's chips are not there.
"""
import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: report the per-layer metrics, from a traced sub-window")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse(sys.argv[1:])
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import bench

    sys.exit(bench.main(args, T0))
