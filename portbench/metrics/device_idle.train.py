"""The share of the traced training steps in which no operation ran on the
device, in %: 1 less the union of the trace's device intervals over the
traced window's length on the host's clock."""
from portbench import yardstick


def read(r):
    return yardstick.idle_share(r.trace, r.records.get("traced_s"))
