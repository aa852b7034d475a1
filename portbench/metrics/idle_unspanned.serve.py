"""The share of the traced wave in which the device idled under no leaf span
of the engine, the window outside ``generate`` included, in %: what the spans
leave unexplained.
The program's spans are joined to the trace by ``hostspans.idle_us``; the
four ``idle_*.serve`` shares sum to ``device_idle.serve``."""
from portbench import hostspans


def read(r):
    try:
        from repro_torch.spans import session
    except ImportError:  # a program that records no spans
        return None
    return hostspans.idle_share(session(), r.trace, r.records.get("traced_s"), "unspanned")
