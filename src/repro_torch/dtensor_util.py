"""DTensor helpers that the kernel wrappers and the model share: a tensor
gathered whole along one dim, and the range of one dim that this rank
holds.  Neither knows the sharding rules (``parallel/sharding.py``)."""
from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def unsplit(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor gathered whole along ``dim`` on every mesh dim that splits
    it, and its pending (partial) sums reduced, its other shards kept; a
    plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    dim = dim % t.ndim
    want = tuple(Replicate() if p == Shard(dim) or p.is_partial() else p for p in t.placements)
    return t if want == t.placements else t.redistribute(t.device_mesh, want)


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
