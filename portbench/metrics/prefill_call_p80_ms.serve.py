"""The 80th percentile of the engine's prefill calls in the window, in ms:
``ServeEngine.call_seconds["prefill"]``, host seconds of each solo prefill
with its logits read back.  A window holds two waves of 32 or more, so ten
or more calls lie beyond it; none is read from fewer than 50."""
import statistics


def read(r):
    calls = r.records.get("prefill_s")
    if not calls or len(calls) < 50:
        return None
    return statistics.quantiles(calls, n=5)[-1] * 1e3
