"""Flash attention in the prefills of the traced wave: the least time of its
calls from their shapes over the device time of their launches
(``flash_prefill_mma_kernel``), in %.  Each prefill is one request whose
prompt length the harness made, and calls it once a layer, a causal
self-attention over the prompt."""
from portbench import yardstick


def read(r):
    prompts = r.records.get("traced_prompts")
    if r.trace is None or not prompts:
        return None
    c = r.cfg
    least = [yardstick.flash_causal_least_ms(1, p, c["num_attention_heads"], c["num_key_value_heads"],
                                             yardstick.head_dim(c)) for p in prompts]
    calls = [ms for ms in least for _ in range(c["num_hidden_layers"])]
    return yardstick.roofline_share(calls, r.trace.kernels("flash_prefill_mma_kernel"))
