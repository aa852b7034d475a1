"""The median over the traced wave's requests of the wait from a request's
arrival in ``generate`` (its ``serve.request`` span's start) to the start of
its solo prefill (``serve.prefill``), in ms."""
from portbench import hostspans


def read(r):
    try:
        from repro_torch.spans import session
    except ImportError:  # a program that records no spans
        return None
    return hostspans.queue_wait_ms(session())
