"""AdamW's update of a training step (``train.adamw``: ``adamw_update``), on
the device: the median over the traced steps of the time between the span's
CUDA events, in ms."""
from portbench import hostspans


def read(r):
    try:
        from repro_torch.spans import session
    except ImportError:  # a program that records no spans
        return None
    return hostspans.step_device_ms(session(), "train.adamw")
