"""The experts' grouped products in the decode steps of the traced wave:
the least time of the work the routing asks for over the device time of
the ``moe.experts`` spans, in %.  A layer's least time
(``yardstick.least_ms``) counts the bf16 weights of its live experts (the
experts holding a kept pair: w_up, w_gate and w_down, 3 D F elements
each) and each kept pair's row in and out, and 6 D F operations a kept
pair; the counts are the ``moe.route`` span's (``kept``, ``live``).
Whatever implements the layer, this is the work it has to do: a dense
product over every expert reaches at most live / E of it."""
from portbench import yardstick


def least_ms(cfg: dict, kept: int, live: int, esize: int = 2) -> float:
    D, F = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return yardstick.least_ms(live * 3 * D * F * esize + 2 * kept * D * esize, 6 * D * F * kept)


def _int(values):
    """Counters as ints: 0-d tensors (read in one copy) or numbers."""
    import torch

    if values and all(isinstance(v, torch.Tensor) for v in values):
        return [int(v) for v in torch.stack(values).tolist()]
    return [int(v) for v in values]


def share(cfg: dict, spans) -> float:
    """Σ least time over Σ device time of the ``moe.experts`` spans inside
    closed ``serve.decode`` spans, in %; None where there are none or one
    lacks its device stamps or its parent's counters."""
    steps = [(s.start, s.end) for s in spans if s.name == "serve.decode" and s.end is not None]
    parents = {s.id: s for s in spans if s.name == "moe.route"}
    parts = [s for s in spans if s.name == "moe.experts" and s.parent in parents
             and any(a <= s.start and s.end is not None and s.end <= b for a, b in steps)]
    if not parts:
        return None
    ms = [s.device_ms() for s in parts]
    routes = [parents[s.parent].attrs for s in parts]
    if None in ms or any("kept" not in a or "live" not in a for a in routes):
        return None
    kept, live = _int([a["kept"] for a in routes]), _int([a["live"] for a in routes])
    least = sum(least_ms(cfg, k, n) for k, n in zip(kept, live))
    return 100.0 * least / sum(ms)


def read(r):
    try:
        from repro_torch.spans import session
    except ImportError:  # a program that records no spans
        return None
    return share(r.cfg, session()) if r.trace is not None else None
