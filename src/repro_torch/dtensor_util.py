"""DTensor helpers that the kernel wrappers and the model share: a tensor
gathered whole along one dim, and the range of one dim that this rank
holds.  Neither knows the sharding rules (``parallel/sharding.py``)."""
from __future__ import annotations

from typing import Tuple

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
