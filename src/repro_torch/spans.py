"""Spans of the port's host work, kept while a ``torch.profiler`` session is
active: whoever profiles the serving engine or the train step gets the
program's own spans for the same window, beside the profiler's trace.

A span is a name, a start and an end on ``time.perf_counter_ns()``, the id
of the span it sits in (``parent``, None at the top) and attributes
(``request_id``, row and key counts).  Opened with ``device=True`` it also
records a CUDA event at open and at close on the current stream;
``Span.device_ms`` reads the device's time between the two once the device
has passed both, and synchronises nothing itself.

The first kept span after one that was not kept (no profiler active)
starts a new session and clears the buffer, so after a profiled window
``session()`` holds exactly that window's spans.  A session keeps at most
``CAP`` spans; later ones are not kept.

With no profiler active ``begin`` checks one flag and returns None, and
``end(None)`` returns at once: no span, no CUDA event.

Spans the port opens (``serve/engine.py``, ``train/train_step.py``,
``models/moe.py``):
``serve.request`` (``request_id``; ``first_token``, the stamp of its first
sampled token), ``serve.prefill`` (``request_id``, ``prompt_len``) with
``serve.cache_init``, ``serve.forward`` and ``serve.readback`` in it,
``serve.insert_row`` (``request_id``), ``serve.sample`` (``rows``: live
rows), ``serve.decode`` (``rows``: the batch; ``keys``: the cached keys the
decode attention visits, over every row) with ``serve.forward`` and
``serve.readback`` in it; ``train.step`` with ``train.forward``,
``train.backward`` (one each a microbatch) and ``train.adamw`` in it, all
three with device stamps on a CUDA device; ``models/moe.py``: ``moe.route``
(``pairs``; ``kept``, ``live``, ``max_load`` as 0-d device tensors) a
mixture-of-experts layer, with ``moe.experts`` in it (device stamps on a
CUDA device); none inside a model call replayed whole from a CUDA graph
(``ServeEngine``'s prefills with ``cuda_graphs``).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import torch

CAP = 1 << 17  # spans a session keeps
now = time.perf_counter_ns
_profiling = torch._C._autograd._profiler_enabled


class Span:
    __slots__ = ("id", "name", "parent", "start", "end", "attrs", "_events")

    def __init__(self, id: int, name: str, parent: Optional[int], start: int,
                 attrs: Dict[str, Any], events: Optional[Tuple[Any, Any]]):
        self.id = id
        self.name = name
        self.parent = parent
        self.start = start
        self.end: Optional[int] = None
        self.attrs = attrs
        self._events = events

    def device_ms(self) -> Optional[float]:
        """Milliseconds on the device between the span's open and close;
        None for a span without device stamps or not closed.  The device
        must have passed the close (a synchronised end)."""
        if self._events is None or self.end is None:
            return None
        return self._events[0].elapsed_time(self._events[1])

    def __repr__(self) -> str:
        return (f"Span({self.id}, {self.name!r}, parent={self.parent}, "
                f"{self.start}-{self.end}, {self.attrs})")


class _Session:
    def __init__(self):
        self.spans: List[Span] = []
        self.live = False  # the last span asked for was kept


_SESSION = _Session()


def begin(name: str, parent: Optional[Span] = None, device: bool = False,
          start: Optional[int] = None, **attrs) -> Optional[Span]:
    """Open a span inside ``parent`` (a span of this session, or None),
    stamped ``start`` (``now()`` if None); None where no profiler is active
    or the session is full."""
    s = _SESSION
    if not _profiling():
        s.live = False
        return None
    if not s.live:
        s.spans.clear()
        s.live = True
    if len(s.spans) >= CAP:
        return None
    events = None
    if device:
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        events[0].record()
    ours = parent is not None and parent.id < len(s.spans) and s.spans[parent.id] is parent
    inside = parent.id if ours else None
    span = Span(len(s.spans), name, inside, now() if start is None else start, attrs, events)
    s.spans.append(span)
    return span


def end(span: Optional[Span], stop: Optional[int] = None) -> None:
    """Close ``span`` (None: nothing) at ``stop`` (``now()`` if None)."""
    if span is None:
        return
    if span._events is not None:
        span._events[1].record()
    span.end = now() if stop is None else stop


def last_open(name: str) -> Optional[Span]:
    """The last span named ``name`` of this session not yet closed; None
    where there is none or no profiler is active."""
    if not _profiling():
        return None
    for span in reversed(_SESSION.spans):
        if span.name == name and span.end is None:
            return span
    return None


def session() -> List[Span]:
    """The spans of the last recording session, in the order opened."""
    return list(_SESSION.spans)
