#!/usr/bin/env python3
"""The SSD scan's calls in the train_4k cells under ``sp`` on the 16x16
mesh, where each rank scans its own 256 sequence rows from the state the
rows before them leave (``repro_torch.kernels.ops._ssd_rows``): one each
for jamba-1.5-large-398b (256 heads) and mamba2-370m (32 heads), bf16 x,
B and C, fp32 dt, A, initial state and y, chunk 128.  Each is launched on
the card from seeded inputs (``chip_smoke.replay_inputs``) and printed as
one JSON line: the route, the worst row error against the plain version,
the kernel's and the plain version's ms (``chip_smoke.Timer``: CUDA
events, L2 flushed) and the bound (``chip_smoke.ssd_bound``).

    python3 scripts/ssd_rows_card.py      # from the repo root, on one GPU
"""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as C  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402


def call(H: int) -> dict:
    """The recorded call (``launch.cost.kernel_call``) with H heads a rank."""
    t = lambda dtype, *shape: {"dtype": dtype, "shape": list(shape)}  # noqa: E731
    return {"kernel": "ssd_scan", "chunk": 128, "out_dtype": "float32", "inputs": {
        "x": t("bfloat16", 16, 256, H, 64), "dt": t("float32", 16, 256, H), "A": t("float32", H),
        "B": t("bfloat16", 16, 256, 128), "C": t("bfloat16", 16, 256, 128),
        "init_state": t("float32", 16, H, 128, 64)}}


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_rows_card: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.load()
    timer, plain = C.Timer(torch, dev), C.plain_versions(torch)
    gen = torch.Generator(device=dev).manual_seed(23)
    for H in (256, 32):
        args, kwargs = C.replay_inputs(torch, call(H), gen, dev)
        before = dict(ops.SSD_ROUTES)
        got = ops.ssd_scan(*args, **kwargs)
        torch.cuda.synchronize()
        with torch.no_grad():
            want = plain["ssd_scan"](*args, **kwargs)
        err = max(C.rel_rows(o, w, 2) for o, w in zip(got, want))
        b_ms, b_by = C.ssd_bound(torch, args[0], args[3], args[5], **kwargs)
        print(json.dumps({
            "call": C.describe_call(call(H)),
            "route": [k for k, n in ops.SSD_ROUTES.items() if n != before[k]],
            "worst_row_rel_l2": err, "tol": C.PLAIN_TOL,
            "ms": timer.ms(lambda: ops.ssd_scan(*args, **kwargs)),
            "plain_ms": timer.ms(lambda: plain["ssd_scan"](*args, **kwargs), iters=5),
            "bound_ms": b_ms, "bound_by": b_by}), flush=True)
        if err > C.PLAIN_TOL:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
