"""The median of the engine's decode calls in the window, in ms:
``ServeEngine.call_seconds["decode"]``, host seconds of each batched decode
step with its logits read back."""
import statistics


def read(r):
    calls = r.records.get("decode_s")
    return statistics.median(calls) * 1e3 if calls else None
