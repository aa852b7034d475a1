"""DTensor helpers that the kernel wrappers and the model share: a tensor
gathered whole along one dim, the range of one dim that this rank holds,
the placements of a gradient each rank computes from its own shard, a
local tensor wrapped as a DTensor, a product with a weight gathered
whole that keeps only the weight's shard for the backward, and the
products into and out of a sequence-split residual that never view it
with (B, S) flattened.  None knows the sharding rules
(``parallel/sharding.py``)."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.torch_version import TorchVersion

# DTensor of torch 2.13 and later, against torch 2.11's: it views a tensor
# split on a dim that a flatten joins to the dim before it (the ``sp``
# residual's (B, S)), keeping the split as a strided one, where 2.11 refuses
# the view; and it has a strategy for an ``index_put`` with split indices
# (an embedding lookup's backward), where 2.11 has none.  The model takes
# explicit placements where this is false.
AT_LEAST_2_13 = TorchVersion(torch.__version__) >= (2, 13)


def unsplit(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor gathered whole along ``dim`` on every mesh dim that splits
    it, and its pending (partial) sums reduced, its other shards kept; a
    plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    dim = dim % t.ndim
    want = tuple(Replicate() if p == Shard(dim) or p.is_partial() else p for p in t.placements)
    return t if want == t.placements else t.redistribute(t.device_mesh, want)


def summed_over_splits(placements) -> Tuple:
    """The placements of a weight's gradient that each rank computes from
    its own shard of an input placed as ``placements``: a partial sum on
    every mesh dim that splits the input, whole on the others."""
    return tuple(Partial() if q.is_shard() else Replicate() for q in placements)


def partial_where_split(placements, split) -> Tuple:
    """The placements of the gradient of an input placed as ``placements``
    that each rank computes from its own part of a result placed as
    ``split``: a partial sum on every mesh dim where the input is whole
    and the result split, as the input is elsewhere."""
    return tuple(Partial() if p == Replicate() and q != Replicate() else p
                 for p, q in zip(placements, split))


def wrap_local(local: torch.Tensor, mesh, placements, shape) -> DTensor:
    """``local``, this rank's shard of a contiguous tensor of global
    ``shape`` placed as ``placements``, as a DTensor (no collective)."""
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape), stride=tuple(reversed(stride)))


def product_with_gathered(a: DTensor, w: DTensor, split: Optional[Sequence[int]] = None):
    """``a @ w`` for ``a [..., K]`` split on its rows and a weight ``w [K,
    E]``, each rank's rows against ``w`` gathered whole (an all-gather of
    a weight, not of an activation); the output is placed as ``a``.  Only
    ``w``'s shard is saved: the backward gathers it again, as XLA gathers
    a weight once for the forward and once for the backward.  ``w``'s
    gradient, each rank's partial sum over its rows, is reduce-scattered
    to ``w``'s own split.  With ``split`` (column counts summing to E), the
    products with each block of w's columns, each its own tensor: a later
    op that keeps one block keeps it alone."""
    blocks = tuple(split) if split is not None else (w.shape[1],)
    out = _GatheredProduct.apply(a, w, blocks, _SavedForProduct.apply(a, w))
    return out if split is not None else out[0]


class _SavedForProduct(torch.autograd.Function):
    """Saves ``(a, w)`` for ``_GatheredProduct``, before the product runs:
    a rematerialised block's recompute stops once every tensor the block
    saves is saved again, so that, as before an aten product (which saves
    its inputs before it computes), it need not compute the product.
    Returns an empty token that carries this node to the product."""

    @staticmethod
    def forward(ctx, a, w):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, w)
        return torch.empty(0, device=a.device)

    @staticmethod
    def backward(ctx, _):
        return None, None


class _GatheredProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, blocks, token):
        ctx.saved = token.grad_fn  # the _SavedForProduct node
        al, mesh = a.to_local(), a.device_mesh
        rows = al.reshape(-1, w.shape[0])
        return tuple(
            wrap_local((rows @ wb).view(*al.shape[:-1], -1), mesh, a.placements, (*a.shape[:-1], n))
            for wb, n in zip(_gathered(w).split(blocks, dim=1), blocks))

    @staticmethod
    def backward(ctx, *gs):
        a, w = ctx.saved.saved_tensors
        mesh, (K, E) = a.device_mesh, w.shape
        al = a.to_local()
        parts = [g.redistribute(mesh, a.placements).to_local() for g in gs]
        gl = (parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)).reshape(-1, E)
        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = wrap_local((gl @ _gathered(w).T).view(al.shape), mesh, a.placements, a.shape)
        if ctx.needs_input_grad[1]:
            sums = summed_over_splits(a.placements)
            gw = wrap_local(al.reshape(-1, K).T @ gl, mesh, sums, w.shape).redistribute(
                mesh, tuple(q if q.is_shard() else s for q, s in zip(w.placements, sums)))
        return ga, gw, None, None


def product_on_rows(x: DTensor, w: DTensor) -> DTensor:
    """``x @ w`` for ``x [B, S, D]`` split on its sequence and a weight
    ``w [D, *E]``, placed as torch 2.13's DTensor places the product of
    the sequence-split residual viewed with (B, S) flattened, without that
    view (torch 2.11 refuses it).  Where ``w`` is split on its second dim
    over the mesh dim that splits S (a column-parallel product: ``wq``,
    ``w_up``, ``w_gate``, ``wk``/``wv`` on split KV heads), x's sequence is
    gathered inside the forward and again in the backward, never saved
    gathered; the output ``[B, S, *E]`` is whole on S and split on E, and
    x's gradient a partial sum there.  Where ``w`` is whole on that mesh
    dim (K/V on KV heads it does not split), each rank multiplies its own
    rows and the output stays split on S.  ``w``'s gradient is each rank's
    partial sum over its rows, kept split where ``w`` is."""
    seq = _split_on(x, 1)
    if w.placements[seq] not in (Shard(1), Replicate()) or any(
            q.is_shard() for i, q in enumerate(w.placements) if i != seq):
        raise ValueError(f"product_on_rows: weight placed {w.placements}")
    return _RowsProduct.apply(x, w, seq, _SavedForProduct.apply(x, w))


def product_to_rows(a: DTensor, w: DTensor, placements) -> DTensor:
    """``a @ w`` for ``a [B, S, *C]`` whole on its sequence, its contraction
    dims C split over the mesh dim that ``placements`` splits S on as
    ``w [*C, D]`` is on its first dim (a row-parallel product: attention's
    out-projection, ``w_down``), placed as ``placements`` (the residual's):
    each rank's partial sums reduce-scattered onto the sequence split.
    The backward gathers the gradient on the sequence for ``a``'s
    gradient and again for ``w``'s, as 2.13's DTensor does for the
    product of the flattened rows."""
    if Shard(1) not in placements:
        raise ValueError(f"product_to_rows: the output placed {placements}, whole on its sequence")
    return _ToRowsProduct.apply(a, w, tuple(placements), _SavedForProduct.apply(a, w))


def _split_on(x: DTensor, dim: int) -> int:
    """The one mesh dim that splits ``x`` on ``dim``."""
    dims = [i for i, p in enumerate(x.placements) if p == Shard(dim)]
    if len(dims) != 1:
        raise ValueError(f"dim {dim} split over {len(dims)} mesh dims: {x.placements}")
    return dims[0]


class _RowsProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, seq, token):
        ctx.saved, ctx.seq = token.grad_fn, seq
        xl, wl = _rows_of(x, w, seq).to_local(), w.to_local()
        out = xl.reshape(-1, x.shape[2]) @ wl.reshape(w.shape[0], -1)
        return wrap_local(out.view(*xl.shape[:2], *wl.shape[1:]), x.device_mesh,
                          _rows_placements(x, w, seq), (*x.shape[:2], *w.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved.saved_tensors
        seq, mesh = ctx.seq, x.device_mesh
        g = g.redistribute(mesh, _rows_placements(x, w, seq)).to_local()
        wl = w.to_local().reshape(w.shape[0], -1)
        gl = g.reshape(-1, wl.shape[1])
        gx = gw = None
        if ctx.needs_input_grad[0]:
            over = list(x.placements)
            if w.placements[seq] == Shard(1):
                over[seq] = Partial()
            gx = wrap_local((gl @ wl.T).view(*g.shape[:2], -1), mesh, over, x.shape)
        if ctx.needs_input_grad[1]:
            xl = _rows_of(x, w, seq).to_local()  # gathered again, as it was not saved
            gw = wrap_local((xl.reshape(-1, x.shape[2]).T @ gl).view(w.to_local().shape),
                            mesh, partial_where_split(w.placements, x.placements), w.shape)
        return gx, gw, None, None


def _rows_of(x: DTensor, w: DTensor, seq: int) -> DTensor:
    """The rows of ``x`` that a rank multiplies by its part of ``w``: every
    row of the sequence where ``w`` is split on its columns, else its own."""
    return unsplit(x, 1) if w.placements[seq] == Shard(1) else x


def _rows_placements(x: DTensor, w: DTensor, seq: int) -> Tuple:
    """The placements of ``_RowsProduct``'s output: split on the output's
    columns over ``seq`` where ``w`` is, else on its sequence, as x is."""
    placed = list(x.placements)
    placed[seq] = Shard(2) if w.placements[seq] == Shard(1) else Shard(1)
    return tuple(placed)


class _ToRowsProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, placements, token):
        ctx.saved = token.grad_fn
        al, wl = a.to_local(), w.to_local()
        k = wl.shape[:a.ndim - 2].numel()
        out = (al.reshape(-1, k) @ wl.reshape(k, -1)).view(*al.shape[:2], -1)
        partial = tuple(Partial() if p.is_shard() and p.dim >= 2 else p for p in a.placements)
        return wrap_local(out, a.device_mesh, partial, (*a.shape[:2], w.shape[-1])).redistribute(
            a.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved.saved_tensors
        mesh = a.device_mesh
        whole = tuple(Replicate() if p.is_shard() and p.dim >= 2 else p for p in a.placements)
        al, wl = a.to_local(), w.to_local()
        k = wl.shape[:a.ndim - 2].numel()

        def gathered():  # g whole on the sequence, freed after the product it enters
            return g.redistribute(mesh, whole).to_local().reshape(-1, wl.shape[-1])

        ga = gw = None
        if ctx.needs_input_grad[0]:
            ga = wrap_local((gathered() @ wl.reshape(k, -1).T).view(al.shape), mesh,
                            a.placements, a.shape)
        if ctx.needs_input_grad[1]:
            gw = wrap_local((al.reshape(-1, k).T @ gathered()).view(wl.shape), mesh,
                            partial_where_split(w.placements, a.placements), w.shape)
        return ga, gw, None, None


def _gathered(w: DTensor) -> torch.Tensor:
    """The local copy of ``w`` gathered whole on every mesh dim."""
    return w.redistribute(w.device_mesh, (Replicate(),) * w.device_mesh.ndim).to_local()


def local_range(t: DTensor, dim: int) -> Tuple[int, int]:
    """[start, stop) of this rank's shard of ``t`` along ``dim``; the
    shards of every mesh dim splitting ``dim`` nest major to minor."""
    start, size = 0, t.shape[dim]
    coord = t.device_mesh.get_coordinate()
    for i, p in enumerate(t.placements):
        if p == Shard(dim):
            n = t.device_mesh.size(i)
            if size % n:
                raise ValueError(f"uneven shard: {size} over {n} ranks")
            size //= n
            start += coord[i] * size
    return start, start + size
