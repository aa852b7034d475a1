"""CUDA graphs of the serving engine's model calls.

A model call launches a few thousand small kernels, and on the card the
host's launches, not the device, then set its pace.  A graph captures the
launches once and replays them at one launch's cost; it runs the kernels
the eager call runs, on the same inputs, so its outputs are the eager
call's bit for bit.  ``ServeEngine`` (``cuda_graphs``) captures a prefill
whole (``Captured``, one a prompt length).  While ``replaying(store)`` is
active, each attention sub-layer of a per-row decode step
(``model._apply_sub``: the attention and the feed-forward half, or up to
the input of a mixture of experts) and each mixture-of-experts layer
(``moe.apply_moe``: routing and dispatch, the grouped products, the
combine) runs from graphs captured at the first call at a key (the
layer's weights, the cache, the shapes) and replayed at every later one.

Between a decode step's graphs the host does what it did: the residual
adds, the spans of ``repro_torch.spans`` and the routing read-out of
``moe.record_routing``, which copies what a replay leaves in the graph's
own buffers.  A graph reads its cache through the pointers it was
captured with, so the caller keeps one cache for every call it replays.
A graph's outputs are its own buffers, overwritten by its next replay.

The calls of ``kernels.ops`` count their launches when captured, not when
replayed.  Only plain CUDA tensors that need no gradient take the graphs;
anything else runs eagerly.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Hashable, Iterator, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

_ACTIVE: Optional["Graphs"] = None


class Captured:
    """``fn(*inputs)`` captured as a CUDA graph by ``store``: ``replay``
    copies new inputs into the graph's own and returns its outputs."""

    def __init__(self, fn: Callable[..., Tuple[torch.Tensor, ...]],
                 inputs: Sequence[torch.Tensor], store: "Graphs"):
        self.inputs = [x.clone() for x in inputs]
        self.graph = torch.cuda.CUDAGraph()
        with store.warm():
            fn(*self.inputs)
        with store.capture(self.graph):
            self.outputs = fn(*self.inputs)

    def replay(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        for mine, x in zip(self.inputs, inputs):
            mine.copy_(x)
        self.graph.replay()
        return self.outputs


class Graphs:
    """The graphs of one caller, by key, all in one memory pool, replayed
    one at a time.  A graph's inputs and outputs are never freed while the
    store lives, so another graph's capture takes none of their memory, and
    the graphs may replay in any order.  Each is warmed up and captured on
    the store's own stream, so that what the libraries set up for a stream
    at its first use (cuBLAS's workspaces) is there before a capture."""

    def __init__(self):
        self._by_key: Dict[Hashable, object] = {}
        self.pool = self.stream = None

    def __len__(self) -> int:
        return len(self._by_key)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._by_key

    def get(self, key: Hashable, build: Callable[["Graphs"], object]):
        """The graphs at ``key``, built by ``build(self)`` at the first call."""
        got = self._by_key.get(key)
        if got is None:
            if self.pool is None:
                self.pool, self.stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream()
            got = self._by_key[key] = build(self)
        return got

    def run(self, key: Hashable, fn: Callable[..., Tuple[torch.Tensor, ...]],
            *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``fn(*inputs)``'s outputs from its graph at ``key``."""
        return self.get(key, lambda store: Captured(fn, inputs, store)).replay(inputs)

    @contextlib.contextmanager
    def warm(self) -> Iterator[None]:
        """A block run eagerly before a capture, on the stream the capture
        takes, so that the allocator's blocks and the libraries' handles and
        workspaces are there when the graph is captured."""
        main = torch.cuda.current_stream()
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            yield
        main.wait_stream(self.stream)

    @contextlib.contextmanager
    def capture(self, graph: torch.cuda.CUDAGraph) -> Iterator[None]:
        """Capture ``graph`` on the store's stream into its pool, with
        Python's cyclic garbage collector held off: an object it collected
        during the capture could destroy another graph, which a capture does
        not permit (the capture then fails)."""
        was = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                yield
        finally:
            if was:
                gc.enable()


@contextlib.contextmanager
def replaying(store: Optional[Graphs]) -> Iterator[None]:
    """Decode steps inside the block run from ``store``'s graphs (None:
    eagerly)."""
    global _ACTIVE
    before, _ACTIVE = _ACTIVE, store
    try:
        yield
    finally:
        _ACTIVE = before


def active(*tensors: torch.Tensor) -> Optional[Graphs]:
    """The store of the ``replaying`` block, where ``tensors`` are plain
    CUDA tensors that need no gradient; None otherwise."""
    if _ACTIVE is None:
        return None
    for t in tensors:
        if isinstance(t, DTensor) or not t.is_cuda or t.requires_grad:
            return None
    return _ACTIVE
