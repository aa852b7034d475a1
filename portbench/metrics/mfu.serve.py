"""Model FLOPs of the requests served in the window over the window and the
H100's bf16 peak, in %.  FLOPs as ``yardstick.serve_request_flops`` counts
them: the matmul weights a token meets, the LM head for each generated
token, and attention over the keys each token sees."""
from portbench import yardstick


def read(r):
    reqs = r.records.get("requests")
    if not reqs:
        return None
    flops = sum(yardstick.serve_request_flops(r.cfg, p, n) for p, n in reqs)
    return 100.0 * flops / r.records["window_s"] / yardstick.PEAK_BF16_FLOPS
