"""Flash attention in the traced training steps: the least time of its calls
from their shapes over the device time of their launches, in %.  A step
calls it twice a layer (the forward, and the recompute of the remat block),
each a causal self-attention over the step's whole batch; the launches are
the ``flash_prefill_mma_kernel`` operations of the trace."""
from portbench import yardstick


def read(r):
    if r.trace is None or "traced_steps" not in r.records:
        return None
    c = r.cfg
    calls = 2 * c["num_hidden_layers"] * r.records["traced_steps"]
    least = yardstick.flash_causal_least_ms(r.records["batch"], r.records["seq"], c["num_attention_heads"],
                                            c["num_key_value_heads"], yardstick.head_dim(c))
    return yardstick.roofline_share([least] * calls, r.trace.kernels("flash_prefill_mma_kernel"))
