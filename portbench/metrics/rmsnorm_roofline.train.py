"""RMSNorm in the traced training steps: the least time of its calls from
their shapes over the device time of their launches (``rmsnorm_kernel`` and
``rmsnorm_row_kernel``), in %.  A step calls it on ``[tokens, hidden]``
before the attention and the feed-forward of each layer, and for a model
with q/k norms on every query and key head's ``[., head_dim]`` rows, each
twice (the forward and the recompute of the remat block), then once for the
final norm."""
from portbench import yardstick


def read(r):
    if r.trace is None or "traced_steps" not in r.records:
        return None
    c = r.cfg
    T, D, K = r.records["batch"] * r.records["seq"], c["hidden_size"], yardstick.head_dim(c)
    layer = [yardstick.rmsnorm_least_ms(T, D)] * 2
    if c.get("qk_norm"):
        layer += [yardstick.rmsnorm_least_ms(T * c["num_attention_heads"], K),
                  yardstick.rmsnorm_least_ms(T * c["num_key_value_heads"], K)]
    step = layer * (2 * c["num_hidden_layers"]) + [yardstick.rmsnorm_least_ms(T, D)]
    return yardstick.roofline_share(step * r.records["traced_steps"], r.trace.kernels("rmsnorm"))
