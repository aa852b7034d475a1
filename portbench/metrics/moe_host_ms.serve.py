"""The host's time in the expert layers of a decode step: the median over
the traced wave's decode steps (``serve.decode`` spans) of the union of the
``moe.*`` spans that open inside the step, in ms.  How much of a
host-paced step the expert layers' launches take: the layer's host work
(routing, dispatch, the grouped products, the combine) of every layer of
the step."""
import statistics


def host_ms(spans):
    """The median over the closed ``serve.decode`` spans of the union of the
    ``moe.*`` spans inside each, in ms; None without both."""
    steps = [s for s in spans if s.name == "serve.decode" and s.end is not None]
    moe = sorted((s.start, s.end) for s in spans if s.name.startswith("moe.") and s.end is not None)
    if not steps or not moe:
        return None
    per_step = []
    for step in steps:
        inside = [(a, b) for a, b in moe if step.start <= a and b <= step.end]
        total, reach = 0, None
        for a, b in inside:  # sorted by start: add what each adds past the reach so far
            if reach is None or a >= reach:
                total, reach = total + b - a, b
            elif b > reach:
                total, reach = total + b - reach, b
        per_step.append(total / 1e6)
    return statistics.median(per_step)


def read(r):
    try:
        from repro_torch.spans import session
    except ImportError:  # a program that records no spans
        return None
    return host_ms(session()) if r.trace is not None else None
