"""The program's spans joined to a profiler's trace of the same window.

The spans are the port's (``repro_torch.spans``): each has ``name``,
``start`` and ``end`` in host nanoseconds (``time.perf_counter_ns``), the
``id`` of its ``parent``, ``attrs`` and ``device_ms()``.  This module takes
them as given and imports nothing of the program, so a reader that finds no
spans (a program without them) returns None before it gets here.

The trace's device times (``yardstick.Trace``, microseconds) keep an origin
of the profiler's own, and on the H100's host they can step by a
millisecond or more within a window against ``perf_counter``.  So the join
fits offsets from the data.  Every ``serve.readback`` span waits for exactly
one ``Memcpy DtoH`` of the trace, in order; the device operations between
two such copies (a segment) were launched after the host returned from the
first read-back and end before it returns from the second.  Each segment so
bounds the offset from both sides; consecutive segments whose bounds
overlap share one offset, the highest their bounds allow (each copy's end
at or before its read-back's end, the tightest at zero), and a new offset
starts where they no longer overlap.
"""
from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

SLACK_US = 50.0  # how far a device operation may lie outside the spans' extent
COPY = "Memcpy DtoH"
# what the engine was doing, by the leaf span open: the idle shares' keys
LEAVES = {"serve.forward": "launch", "serve.sample": "sample", "serve.readback": "sample",
          "serve.cache_init": "admit", "serve.insert_row": "admit"}
KINDS = ("launch", "sample", "admit", "unspanned")


def closed(spans: Sequence) -> List:
    return [s for s in spans if s.end is not None]


def offsets_us(spans: Sequence, trace) -> Optional[List[Tuple[float, float]]]:
    """The offsets that take the trace's times to the spans' clock, in µs:
    ``(device end of a segment's copy, offset)`` for each read-back, in
    order.  None where the trace's device-to-host copies and the read-back
    spans differ in number."""
    spans = closed(spans)
    reads = [s for s in spans if s.name == "serve.readback"]
    copies = trace.kernels(COPY) if trace is not None else []
    if not reads or len(copies) != len(reads):
        return None
    starts = [e[1] for e in trace.device]
    bounds = []  # (copy end, least offset, most offset) of each segment
    host_back, device_back = min(s.start for s in spans) / 1e3, float("-inf")
    for r, (_, copy_start, copy_end) in zip(reads, copies):
        i = bisect.bisect_right(starts, device_back)
        first = min(starts[i], copy_start) if i < len(starts) else copy_start
        bounds.append((copy_end, host_back - first, r.end / 1e3 - copy_end))
        host_back, device_back = r.end / 1e3, copy_end
    out, run, lo, hi = [], [], float("-inf"), float("inf")
    for end, least, most in bounds:
        if run and max(lo, least) > min(hi, most):
            out += [(e, hi) for e in run]
            run, lo, hi = [], float("-inf"), float("inf")
        run.append(end)
        lo, hi = max(lo, least), min(hi, most)
    return out + [(e, hi) for e in run]


def on_host(spans: Sequence, trace) -> Optional[List[Tuple[str, float, float]]]:
    """The trace's device operations on the spans' clock (µs), each moved by
    the offset of its segment (the first copy that ends at or after it);
    None where ``offsets_us`` is, or where an operation lies more than
    ``SLACK_US`` outside the extent of the spans once joined."""
    offs = offsets_us(spans, trace)
    if offs is None:
        return None
    ends = [e for e, _ in offs]
    moved = []
    for name, a, b in trace.device:
        off = offs[min(bisect.bisect_left(ends, b), len(offs) - 1)][1]
        moved.append((name, a + off, b + off))
    spans = closed(spans)
    first, last = min(s.start for s in spans) / 1e3, max(s.end for s in spans) / 1e3
    if any(a < first - SLACK_US or b > last + SLACK_US for _, a, b in moved):
        return None
    return moved


def idle_us(spans: Sequence, trace, window_s: Optional[float]) -> Optional[Dict[str, float]]:
    """The device's idle time in a traced window of ``window_s`` on the
    host's clock, in µs, split by the leaf span open at each instant
    (``LEAVES``; the leaves do not overlap): ``launch``, ``sample``,
    ``admit``, and ``unspanned``, the rest of the device's idle time (under
    no leaf span, or outside the spans' extent).  The four sum to the
    window less the trace's busy time (``yardstick.idle_share``).  None
    where the join fails or there is no window."""
    moved = on_host(spans, trace) if window_s else None
    if moved is None:
        return None
    spans = closed(spans)
    first, last = min(s.start for s in spans) / 1e3, max(s.end for s in spans) / 1e3
    leaves = sorted((s.start / 1e3, s.end / 1e3, LEAVES[s.name]) for s in spans if s.name in LEAVES)
    gaps, t = [], first
    for _, a, b in sorted(moved, key=lambda e: e[1]):
        a, b = max(a, first), min(b, last)
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if last > t:
        gaps.append((t, last))
    out = dict.fromkeys(KINDS, 0.0)
    i = 0
    for a, b in gaps:
        while i < len(leaves) and leaves[i][1] <= a:
            i += 1
        j = i
        while j < len(leaves) and leaves[j][0] < b:
            out[leaves[j][2]] += min(b, leaves[j][1]) - max(a, leaves[j][0])
            j += 1
    out["unspanned"] = window_s * 1e6 - trace.busy_seconds() * 1e6 - sum(out[k] for k in KINDS[:3])
    return out


def idle_share(spans: Sequence, trace, window_s: Optional[float], kind: str) -> Optional[float]:
    """``idle_us``'s ``kind`` over the window, in %."""
    split = idle_us(spans, trace, window_s)
    return None if split is None else 100.0 * split[kind] / (window_s * 1e6)


def queue_wait_ms(spans: Sequence) -> Optional[float]:
    """The median over the requests of the wait from a ``serve.request``'s
    start to its ``serve.prefill``'s, in ms; None without requests."""
    arrived = {s.attrs["request_id"]: s.start for s in spans if s.name == "serve.request"}
    waits = [(s.start - arrived[s.attrs["request_id"]]) / 1e6 for s in spans
             if s.name == "serve.prefill" and s.attrs["request_id"] in arrived]
    return statistics.median(waits) if waits else None


def step_device_ms(spans: Sequence, name: str) -> Optional[float]:
    """The median over the closed ``train.step`` spans of the device time of
    their ``name`` spans (summed over a step's microbatches), in ms; None
    where a step has no such span or one without device stamps."""
    steps = {s.id: [] for s in closed(spans) if s.name == "train.step"}
    for s in spans:
        if s.name == name and s.parent in steps:
            steps[s.parent].append(s.device_ms())
    per_step = [sum(ms) for ms in steps.values() if ms and None not in ms]
    if not per_step or len(per_step) != len(steps):
        return None
    return statistics.median(per_step)
