"""Mixture-of-Experts FF layer of the port: top-k router and
capacity-bounded dispatch (the JAX package's ``repro/models/moe.py``).

Each (token, k) pair goes to its expert's slot in an ``[E, C, D]`` slab,
where ``C = moe_capacity(cfg, T)`` for the ``T = B * S`` tokens of the
call; pairs past an expert's capacity are dropped (Switch-style), in
row-major (token, k) priority.  The experts run as three batched products
over all E experts (a grouped SwiGLU), and each token's output is the sum
of its kept pairs' expert outputs weighted by the renormalised router
probabilities.  Plain PyTorch: the reference's MoE reaches no Pallas
kernel.

Layouts: router ``[D, E]`` fp32 whatever ``cfg.dtype`` is; ``w_up``,
``w_gate`` ``[E, D, F]`` and ``w_down`` ``[E, F, D]`` in ``cfg.dtype``.
On DTensors the slab is placed over the mesh (``_placed_route``,
``_placed_experts``: the same slots and outputs), or, under ``moe_a2a``,
the expert-parallel ``apply_moe_shard_map`` runs.

**Routing read-out** (``record_routing``): while a recorder is active,
every routing call keeps its expert choices, slots and drops as device
tensor references (no wait; a copy where the layer runs from CUDA graphs,
whose buffers the next replay overwrites), tagged by the caller
(``tag_routing``: the serving engine names each model call's kind and the
request of each of its rows), so that a checker can replay them.  Later
implementations of the layer keep this contract.  With no recorder active
a routing call checks one flag.

**Spans** (``repro_torch.spans``, kept only under an active profiler): a
``moe.route`` span a layer (the whole layer: scores, top-k, slots,
dispatch, experts, combine) with ``pairs`` (T K), and ``kept``, ``live``
(experts holding a kept pair) and ``max_load`` (the most pairs that chose
one expert) as 0-d device tensors, read after the window; inside it a
``moe.experts`` span around the grouped products, with device stamps on a
CUDA device.

**CUDA graphs** (``models/graphs.py``, the serving engine's): inside
``graphs.replaying`` (decode steps) a layer of plain CUDA tensors runs as
three graphs a token count (``_Replayed``: routing and dispatch, the
grouped products, the combine), the same kernels on the same inputs, with
the spans and the read-out around the replays as above.  A graph captured
around whole layers (the engine's prefills) lists its routing calls with
``capture_routing`` and records copies of them with ``replayed`` after
each replay; its layers open no spans when replayed.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .. import spans
from ..configs.base import ArchConfig
from ..parallel import opt_flags
from ..parallel.sharding import (
    axis_size, batch_axes, constrain, maybe, replicated, to_placements,
)
from . import graphs
from . import layers as L

Params = Dict[str, Any]


def moe_spec(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """Shape and init of each MoE leaf (see ``layers.init_from_spec``)."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ((D, E), ("normal_fp32", D**-0.5)),
        "w_up": ((E, D, F_), D**-0.5),
        "w_gate": ((E, D, F_), D**-0.5),
        "w_down": ((E, F_, D), F_**-0.5),
    }


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return L.init_from_spec(gen, moe_spec(cfg), L.dtype_of(cfg))


def moe_capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots per expert for a call of ``n_tokens`` tokens: Python's
    ``round`` (half to even), then up to a multiple of 8, at least 8."""
    cap = int(round(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)


class Routing(NamedTuple):
    """The router's decision for ``T`` tokens and ``K`` choices each."""

    probs: torch.Tensor  # [T, E] fp32 softmax of the router logits
    top_p: torch.Tensor  # [T, K] fp32, renormalised to sum 1 per token
    top_i: torch.Tensor  # [T, K] int64 expert ids, most probable first
    load: torch.Tensor  # [E] int64 pairs that chose each expert, kept or not
    slot: torch.Tensor  # [T*K] the pair's row in its expert's slab; C if dropped
    keep: torch.Tensor  # [T*K] bool, the pair got a slot
    capacity: int  # C
    expert: torch.Tensor  # [T*K] the pair's slab: its expert, less the first routed one


class Routed(NamedTuple):
    """One routing call as a recorder keeps it."""

    call: int  # its model call: one a ``tag_routing``, from 0 (-1 before the first)
    layer: int  # its place among the call's routing calls, from 0
    kind: str  # the call's kind as tagged ("prefill", "decode"; "" untagged)
    rows: Tuple  # the request of each row of the call (None: a riding row)
    top_i: torch.Tensor  # [T, K] the experts chosen, most probable first
    slot: torch.Tensor  # [T*K] each pair's slot; the capacity where dropped
    keep: torch.Tensor  # [T*K] bool, the pair got a slot


class RoutingRecorder:
    """The routing calls made while it is active (``records``)."""

    def __init__(self):
        self.records: List[Routed] = []
        self._call, self._kind, self._rows, self._layer = -1, "", (), 0

    def tag(self, kind: str, rows: Sequence) -> None:
        """The routing calls that follow belong to a new model call of
        ``kind`` whose row r serves request ``rows[r]``."""
        self._call, self._kind, self._rows, self._layer = self._call + 1, kind, tuple(rows), 0

    def clear(self) -> None:
        """Drop what was recorded; the tags go on."""
        self.records = []

    def add(self, r: "Routing") -> None:
        self.records.append(Routed(self._call, self._layer, self._kind, self._rows,
                                   r.top_i, r.slot, r.keep))
        self._layer += 1


_RECORDER: Optional[RoutingRecorder] = None


@contextlib.contextmanager
def record_routing() -> Iterator[RoutingRecorder]:
    """Record every routing call made inside the block; one recorder at a
    time."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("a routing recorder is already active")
    _RECORDER = rec = RoutingRecorder()
    try:
        yield rec
    finally:
        _RECORDER = None


def recording() -> bool:
    return _RECORDER is not None


_CAPTURED: Optional[List[Routing]] = None


@contextlib.contextmanager
def capture_routing() -> Iterator[List[Routing]]:
    """Around the capture of a CUDA graph that routes: the routing calls
    captured inside the block are listed (the graph's own tensors), and the
    calls run eagerly to warm it up are not recorded.  After each replay,
    ``replayed`` records copies of the listed calls."""
    global _CAPTURED
    if _CAPTURED is not None:
        raise RuntimeError("a routing capture is already active")
    _CAPTURED = got = []
    try:
        yield got
    finally:
        _CAPTURED = None


def replayed(captured: Sequence[Routing]) -> None:
    """Record a replayed graph's routing calls (``capture_routing``'s list)
    as copies, since the next replay overwrites the graph's tensors;
    nothing without an active recorder."""
    if _RECORDER is not None:
        for r in captured:
            _RECORDER.add(r._replace(top_i=r.top_i.clone(), slot=r.slot.clone(), keep=r.keep.clone()))


def tag_routing(kind: str, rows: Sequence) -> None:
    """Tag the routing calls that follow (``RoutingRecorder.tag``); nothing
    without an active recorder."""
    if _RECORDER is not None:
        _RECORDER.tag(kind, rows)


def _scores(router: torch.Tensor, cfg: ArchConfig, xt: torch.Tensor):
    """(probs [T, E], top_p [T, K] renormalised, top_i [T, K])."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1, sorted=True)
    return probs, top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9), top_i


def route(
    router: torch.Tensor, cfg: ArchConfig, xt: torch.Tensor,
    experts: Optional[Tuple[int, int]] = None,
) -> Routing:
    """Top-k routing of ``xt [T, D]`` with capacity: a pair's slot is the
    number of pairs before it, in row-major (token, k) order, that chose
    the same expert; pairs with slot >= C are dropped.  ``experts`` =
    (first, count) routes to those experts alone (a rank's own under
    expert parallelism): a pair to any other is dropped, and slabs are
    numbered from ``first``.  On DTensors, ``_placed_route``."""
    r = _placed_route(router, cfg, xt) if isinstance(xt, DTensor) else _route(router, cfg, xt, experts)
    if _CAPTURED is not None:
        if torch.cuda.is_current_stream_capturing():
            _CAPTURED.append(r)
    elif _RECORDER is not None:
        _RECORDER.add(r)
    return r


def _route(router: torch.Tensor, cfg: ArchConfig, xt: torch.Tensor,
           experts: Optional[Tuple[int, int]] = None) -> Routing:
    """``route`` of a plain tensor, unrecorded."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, T)
    probs, top_p, top_i = _scores(router, cfg, xt)
    flat_e = top_i.reshape(T * K)
    pos, load = _positions(flat_e, E)
    expert, keep = flat_e, pos < C
    if experts is not None:
        first, count = experts
        mine = (flat_e >= first) & (flat_e < first + count)
        expert, keep = torch.where(mine, flat_e - first, 0), mine & keep
    return Routing(probs, top_p, top_i, load, torch.where(keep, pos, C), keep, C, expert)


def _positions(e: torch.Tensor, E: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(each pair's rank among the earlier pairs that chose its expert,
    each expert's pair count), for pairs ``e [n]`` in row-major (token, k)
    order: a stable sort by expert, where a ``[n, E]`` one-hot's cumsum
    over its n rows is a slow outer-dim scan on the card."""
    order = torch.sort(e, stable=True).indices
    count = torch.zeros(E, dtype=torch.int64, device=e.device).index_add_(0, e, torch.ones_like(e))
    pos = torch.empty_like(e)
    pos[order] = torch.arange(e.numel(), device=e.device) - (count.cumsum(0) - count)[e[order]]
    return pos, count


COUNTED = ("kept", "live", "max_load")


def _counts(r: Routing) -> torch.Tensor:
    """The ``moe.route`` span's device counters (``COUNTED``) of a routing
    over every expert, stacked: ``kept`` pairs (an expert keeps min(its
    pairs, C)), ``live`` experts (any with a pair: slot 0 is always kept)
    and ``max_load``."""
    kept = torch.clamp(r.load, max=r.capacity)
    return torch.stack([kept.sum(), (kept > 0).sum(), r.load.max()])


def _aux(r: Routing, cfg: ArchConfig) -> torch.Tensor:
    """Switch aux loss: E * sum_e(token fraction_e * mean prob_e)."""
    T, K = r.top_i.shape
    return cfg.n_experts * torch.sum(r.load.float() / (T * K) * r.probs.mean(0))


def _dispatch(x: torch.Tensor, expert, slot, keep, first: int, n_loc: int, C: int) -> torch.Tensor:
    """The ``[n_loc, C, D]`` slabs ``first ..`` of pairs ``(expert, slot,
    keep) [T*K]`` of tokens ``x [T, D]``: each slot holds the token of the
    kept pair that fills it, or zeros.  Kept (slab, slot) pairs are unique,
    so a gather by the pair that fills each slot is the reference's
    scatter-add."""
    n_pairs, D = expert.shape[0], x.shape[1]
    ok = keep & (expert >= first) & (expert < first + n_loc)
    fill = torch.full((n_loc * C + 1,), n_pairs, dtype=torch.int64, device=x.device)
    fill[torch.where(ok, (expert - first) * C + slot, n_loc * C)] = torch.arange(
        n_pairs, device=x.device)  # scratch entry n_loc * C takes the others
    fill = fill[:-1]
    part = x[torch.div(fill, n_pairs // x.shape[0], rounding_mode="floor").clamp(max=x.shape[0] - 1)]
    return part.masked_fill_((fill == n_pairs)[:, None], 0).view(n_loc, C, D)


def _combine(out: torch.Tensor, expert, slot, keep, top_p, first: int) -> torch.Tensor:
    """``[T, D]``: each token's pairs kept in slabs ``out [n_loc, C, D]``
    (slabs ``first ..``), weighted by ``top_p [T, K]`` and summed over its
    K pairs; a pair in no slab of ``out`` adds zeros.  A sum over a ``[T,
    K, D]`` view, not index_add_, whose CUDA adds come in no fixed order."""
    n_loc, C, D = out.shape
    ok = keep & (expert >= first) & (expert < first + n_loc)
    gathered = out.view(n_loc * C, D)[torch.where(ok, (expert - first) * C + slot, 0)]
    gathered.masked_fill_(~ok[:, None], 0)
    weights = (top_p.reshape(-1) * keep).to(gathered.dtype)
    return (gathered * weights[:, None]).view(-1, top_p.shape[1], D).sum(1)


def _swiglu(buf: torch.Tensor, w_up, w_gate, w_down) -> torch.Tensor:
    """The grouped SwiGLU over every slab of ``buf [n, C, D]``."""
    up = torch.bmm(buf, w_up)
    gate = torch.bmm(buf, w_gate)
    return torch.bmm(F.silu(gate) * up, w_down)


def _experts(p: Params, xt: torch.Tensor, r: Routing, n_slabs: int,
             span: Optional[spans.Span] = None) -> torch.Tensor:
    """Dispatch, grouped SwiGLU and combine: ``[T, D]``, each token's kept
    pairs' expert outputs weighted and summed; the products in a
    ``moe.experts`` span inside ``span``.  On DTensors,
    ``_placed_experts``."""
    if isinstance(xt, DTensor):
        return _placed_experts(p, xt, r)
    buf = _dispatch(xt, r.expert, r.slot, r.keep, 0, n_slabs, r.capacity)
    part = spans.begin("moe.experts", span, device=xt.is_cuda)
    out = _swiglu(buf, p["w_up"], p["w_gate"], p["w_down"])
    spans.end(part)
    return _combine(out, r.expert, r.slot, r.keep, r.top_p, 0)


# --------------------------------------------------------------------------
# on DTensors: the dispatch slab placed, never whole on a device
# --------------------------------------------------------------------------


def _placed_route(router: DTensor, cfg: ArchConfig, xt: DTensor) -> Routing:
    """``route`` of tokens split over the batch axes (``xt`` Shard(0)
    there, whole on the other mesh dims; the router whole): each rank
    routes its own tokens as the plain route does, then adds to each
    pair's rank among its expert's pairs the pairs of the ranks before it
    in the batch split (an all-gather of each rank's ``[E]`` counts).  The
    integers are the plain route's on the whole tensor exactly.  The
    gradients of xt and the router are each rank's own (placed as xt, and
    a sum over the batch axes)."""
    mesh, pl = xt.device_mesh, xt.placements
    T, E = xt.shape[0], cfg.n_experts
    C = moe_capacity(cfg, T)
    rep = replicated(mesh)

    def local(x, w):
        probs, top_p, top_i = _scores(w, cfg, x)
        pos, count = _positions(top_i.reshape(-1), E)
        return probs, top_p, top_i, pos, count[None]

    over_batch = tuple(Partial() if q == Shard(0) else r for q, r in zip(pl, rep))
    probs, top_p, top_i, pos, counts = local_map(
        local, out_placements=(pl,) * 5, in_placements=(pl, rep),
        in_grad_placements=(pl, over_batch), device_mesh=mesh)(xt, router)
    counts = counts.redistribute(mesh, rep)  # [ranks of the batch split, E]
    before = (counts.cumsum(0) - counts).redistribute(mesh, pl)  # each rank's own row
    flat_e = top_i.reshape(-1)
    pos = local_map(lambda q, e, b: q + b[0][e], out_placements=(pl,),
                    in_placements=(pl, pl, pl), device_mesh=mesh)(pos, flat_e, before)
    keep = pos < C
    return Routing(probs, top_p, top_i, counts.sum(0), torch.where(keep, pos, C), keep, C, flat_e)


def _placed_experts(p: Params, xt: DTensor, r: Routing) -> DTensor:
    """``_experts`` on DTensors, its ``[E, C, D]`` slab never whole on a
    device: E on `model` (the experts' own split, where XLA's partitioner
    puts it in the reference's einsums) and C over the batch axes, so
    that each expert product is a local one.  (XLA keeps C whole and
    splits each product's contraction over the batch axes instead,
    reducing ``[E/model, C, .]`` partial sums: the same FLOPs a device,
    with more memory and more bytes moved.)  Each rank builds, from its
    own tokens, the part of its experts' slabs that they fill (a gather,
    zero rows where no pair of its tokens lands), and a reduce-scatter
    over the batch axes sums the parts into each rank's slots.
    The combine gathers ``out``'s slots back over the batch axes and each
    rank weights its own tokens' pairs to its experts; a sum over `model`
    adds the experts of the other ranks.  C is padded up to a multiple of
    the batch split with zero rows, which no pair reads.

    Under ``moe_ep`` the slabs are pinned to ``("model", None, None)``,
    whole over the batch axes, and the products split d_ff over them, as
    XLA's partitioner runs the reference's einsums there: each rank takes
    its slice of the weights' d_ff, and the last product's sum over the
    slices is reduced."""
    mesh, pairs = xt.device_mesh, xt.placements
    names = tuple(mesh.mesh_dim_names)
    n = p["w_up"].shape[0]
    batch = tuple(i for i, q in enumerate(pairs) if q == Shard(0))
    split = 1
    for i in batch:
        split *= mesh.size(i)
    C = -(-r.capacity // split) * split
    m = maybe(mesh, n, "model")
    n_loc = n // axis_size(mesh, "model") if m else n
    first = mesh.get_local_rank(names.index("model")) * n_loc if m else 0
    b = tuple(names[i] for i in batch) or None
    whole_b = to_placements((m, None, None), mesh)  # whole over the batch axes
    partial = tuple(Partial() if i in batch else q for i, q in enumerate(whole_b))
    over_model = tuple(Partial() if names[i] == "model" and m else q for i, q in enumerate(pairs))

    part = local_map(lambda *a: _dispatch(*a, first, n_loc, C), out_placements=(partial,),
                     in_placements=(pairs,) * 4,
                     in_grad_placements=(over_model, pairs, pairs, pairs),
                     device_mesh=mesh)(xt, r.expert, r.slot, r.keep)
    if opt_flags.get("moe_ep"):
        buf = part.redistribute(mesh, whole_b)
        f_split = p["w_up"].shape[2] % split == 0
        out = _swiglu(buf, *(_split_over(p[k], d, batch, f_split)
                             for k, d in (("w_up", 2), ("w_gate", 2), ("w_down", 1))))
    else:
        buf = part.redistribute(mesh, to_placements((m, b, None), mesh))
        out = _swiglu(buf, p["w_up"], p["w_gate"], p["w_down"])  # [n, C, D], placed as buf
    out = out.redistribute(mesh, whole_b)  # each rank's experts, every slot

    y = local_map(lambda *a: _combine(*a, first), out_placements=(over_model,),
                  in_placements=(whole_b,) + (pairs,) * 4,
                  in_grad_placements=(partial, pairs, pairs, pairs, over_model),
                  device_mesh=mesh)(out, r.expert, r.slot, r.keep, r.top_p)
    return y.redistribute(mesh, pairs)


def _split_over(w: DTensor, dim: int, batch: Tuple[int, ...], split: bool) -> DTensor:
    """An expert weight with ``dim`` split over the mesh dims ``batch``
    (a local slice where it is whole there), or, unless ``split``, whole
    over them."""
    want = tuple((Shard(dim) if split else Replicate()) if i in batch else q
                 for i, q in enumerate(w.placements))
    return w.redistribute(w.device_mesh, want)


def apply_moe(p: Params, cfg: ArchConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B,S,D] in x's dtype, fp32 aux load-balance loss
    ``E * sum_e(frac_e * mean prob_e)``).  Under the ``moe_a2a`` flag, with
    a mesh set, the expert-parallel ``apply_moe_shard_map``."""
    if opt_flags.get("moe_a2a") and opt_flags.get("mesh") is not None:
        return apply_moe_shard_map(p, cfg, x, opt_flags.get("mesh"), opt_flags.get("batch_axes"))
    B, S, D = x.shape
    rows = x.placements if L.on_sequence_rows(x) else None
    if isinstance(x, DTensor):  # tokens over the batch axes, whole on `model`
        x = constrain(x, (batch_axes(x.device_mesh, B), None, None))
    xt = x.reshape(B * S, D)
    span = spans.begin("moe.route", pairs=B * S * cfg.top_k)
    g = graphs.active(xt)
    if g is not None:
        layer = g.get(("moe", p["router"].data_ptr(), tuple(xt.shape), xt.dtype),
                      lambda store: _Replayed(p, cfg, xt, store))
        y, aux = layer(xt, span)
        spans.end(span)
        return y.view(B, S, D), aux
    r = route(p["router"], cfg, xt)
    if span is not None and not isinstance(xt, DTensor):
        span.attrs.update(zip(COUNTED, _counts(r).unbind()))
    y = _experts(p, xt, r, cfg.n_experts, span).view(B, S, D)
    if rows is not None:  # placed as its input: its gradient comes back gathered, not
        y = y.redistribute(y.device_mesh, rows)  # split on S, which 2.11 cannot view as (B*S, D)
    aux = _aux(r, cfg)
    spans.end(span)
    return y, aux


class _Replayed:
    """A layer of plain CUDA tensors at one token count as three CUDA
    graphs: routing, dispatch and the span's counters; the grouped
    products; the combine and aux.  The ``moe.experts`` span's device
    stamps and the routing read-out sit between the replays."""

    def __init__(self, p: Params, cfg: ArchConfig, xt: torch.Tensor, store: graphs.Graphs):
        self.x = xt.clone()

        def routed() -> Tuple[Routing, torch.Tensor, torch.Tensor]:
            r = _route(p["router"], cfg, self.x)
            return r, _dispatch(self.x, r.expert, r.slot, r.keep, 0, cfg.n_experts, r.capacity), _counts(r)

        def experts(buf: torch.Tensor) -> torch.Tensor:
            return _swiglu(buf, p["w_up"], p["w_gate"], p["w_down"])

        def combined(r: Routing, out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
            return _combine(out, r.expert, r.slot, r.keep, r.top_p, 0), _aux(r, cfg)

        with store.warm():
            r, buf, _ = routed()
            combined(r, experts(buf))
        self.route, self.experts, self.combine = (torch.cuda.CUDAGraph() for _ in range(3))
        with store.capture(self.route):
            self.r, self.buf, self.counts = routed()
        with store.capture(self.experts):
            self.out = experts(self.buf)
        with store.capture(self.combine):
            self.y, self.aux = combined(self.r, self.out)

    def __call__(self, xt: torch.Tensor, span: Optional[spans.Span]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the layer's output ``[T, D]``, aux), both the graphs' own
        buffers, for tokens ``xt``; the experts' products in a
        ``moe.experts`` span inside ``span``."""
        self.x.copy_(xt)
        self.route.replay()
        if span is not None:
            span.attrs.update(zip(COUNTED, self.counts.clone().unbind()))
        replayed((self.r,))
        part = spans.begin("moe.experts", span, device=True)
        self.experts.replay()
        spans.end(part)
        self.combine.replay()
        return self.y, self.aux


# --------------------------------------------------------------------------
# expert parallelism: local dispatch (no global cumsum, no slab all-reduce)
# --------------------------------------------------------------------------


class _SumOverRanks(torch.autograd.Function):
    """The sum of each rank's tensor over a process group (JAX's ``psum``
    of a shard_map body).  Backward: the identity, since the sum's
    gradient reaches every rank whole (its output is replicated there)."""

    @staticmethod
    def forward(ctx, t, group):
        c10d = torch.ops._c10d_functional
        return c10d.wait_tensor(c10d.all_reduce(t, "sum", group.group_name))

    @staticmethod
    def backward(ctx, g):
        return g, None


def apply_moe_shard_map(
    p: Params, cfg: ArchConfig, x: torch.Tensor, mesh, batch_axes
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE (the reference's shard_map version).

    Tokens stay batch-sharded and replicated over `model`; each model
    rank routes every local token, keeps only the slots of its own
    ``E_loc = E / TP`` experts, computes them from a *local* capacity
    buffer (local cumsum, no cross-shard prefix sum), and the combine is
    one sum of the ``[T_loc, D]`` output over `model`.  Per layer, the
    communication drops from an ``[E, C, D]`` all-reduce and a ``[T*K,
    E]`` global cumsum to one activation-sized all-reduce.

    ``x`` and the params are DTensors on ``mesh``; each is first placed
    as the reference's ``in_specs`` (x on ``batch_axes``, the router
    whole, the experts split on `model`).  Capacity and aux are those of
    the rank's own tokens: aux is their mean over `model` (every model
    rank routes the same tokens) and, over the batch split, the mean of
    the ranks' values.  Gradients flow back through the local function.
    """
    if not isinstance(x, DTensor):
        raise TypeError("apply_moe_shard_map: x and the params must be DTensors on the mesh")
    names = tuple(mesh.mesh_dim_names)
    E, K, D = cfg.n_experts, cfg.top_k, cfg.d_model
    m = names.index("model")
    model_size = mesh.size(m)
    if E % model_size:
        raise ValueError(f"apply_moe_shard_map: {E} experts over {model_size} model ranks")
    E_loc = E // model_size
    bdims = [names.index(a) for a in
             ((batch_axes,) if isinstance(batch_axes, str) else tuple(batch_axes or ()))]
    n_batch = 1
    for i in bdims:
        n_batch *= mesh.size(i)

    def place(spec):
        return to_placements(spec, mesh)

    x_p = place((batch_axes, None, None))
    w_p = place(("model", None, None))
    rep = replicated(mesh)
    over = lambda dims, base: tuple(  # noqa: E731
        Partial() if i in dims else q for i, q in enumerate(base))
    group = mesh.get_group(m)
    rank = mesh.get_local_rank(m)

    def local_moe(xb, router, w_up, w_gate, w_down):
        B_loc, S, _ = xb.shape
        xt = xb.reshape(B_loc * S, D)
        r = route(router, cfg, xt, (rank * E_loc, E_loc))
        w = {"w_up": w_up, "w_gate": w_gate, "w_down": w_down}
        y = _SumOverRanks.apply(_experts(w, xt, r, E_loc), group)
        aux = _SumOverRanks.apply(_aux(r, cfg), group) / model_size
        return y.view(B_loc, S, D), aux / n_batch

    return local_map(
        local_moe,
        out_placements=(x_p, over(bdims, rep)),
        in_placements=(x_p, rep, w_p, w_p, w_p),
        in_grad_placements=(over({m}, x_p), over(set(bdims) | {m}, rep),
                            over(bdims, w_p), over(bdims, w_p), over(bdims, w_p)),
        device_mesh=mesh,
    )(
        x.redistribute(mesh, x_p), p["router"].redistribute(mesh, rep),
        p["w_up"].redistribute(mesh, w_p), p["w_gate"].redistribute(mesh, w_p),
        p["w_down"].redistribute(mesh, w_p),
    )
