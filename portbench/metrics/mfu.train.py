"""Model FLOPs of the window's steps over the window and the H100's bf16
peak, in %.  FLOPs as ``yardstick.train_step_flops`` counts them: the
matmul weights a token meets and the LM head, times 6, and causal
attention, its backward twice; no recompute."""
from portbench import yardstick


def read(r):
    steps = r.records.get("steps")
    if not steps:
        return None
    flops = steps * yardstick.train_step_flops(r.cfg, r.records["batch"], r.records["seq"])
    return 100.0 * flops / r.records["window_s"] / yardstick.PEAK_BF16_FLOPS
