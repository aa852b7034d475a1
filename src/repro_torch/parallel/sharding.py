"""Sharding rules of the port: the JAX package's
``repro/parallel/sharding.py`` on a torch ``DeviceMesh``.

Mesh axes: ('data', 'model') single-pod, ('pod', 'data', 'model') multi-pod.

Strategy (as in the reference):
* 2-D param sharding — tensor-parallel dims (heads, ff, experts, vocab) on
  `model`; the other large dim on `data` (FSDP/ZeRO-3 style).  The model
  gathers a block's FSDP shards before the block runs (``gather_fsdp``),
  and the backward reduce-scatters their grads.
* activations: batch on ('pod', 'data') when divisible; attention heads /
  expert dim on `model`.
* KV caches: batch on ('pod','data') when divisible, else sequence on
  'data'; kv-head dim on `model` only when divisible (MQA replicates kv).

Every rule degrades to replication when a dim isn't divisible, so no
shard is ever uneven (DTensor itself would shard an uneven dim).

The rule functions return the reference's specs: one entry per tensor
dim, an axis name, a tuple of names (major to minor) or None.  A mesh is
anything with ``mesh_dim_names`` and a ``shape`` tuple, a ``DeviceMesh``
or a stand-in of the production extents.  ``to_placements`` turns a spec
into DTensor placements; ``param_shardings``, ``batch_shardings``,
``cache_shardings`` and ``replicated`` give trees of placements, and
``distribute`` places a tree of tensors by one.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from ..configs.base import ArchConfig
from ..tree import leaves_with_paths, tree_map, unflatten

Spec = Tuple[Any, ...]
Placements = Tuple[Placement, ...]


def axis_size(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names)
    return mesh.shape[names.index(name)] if name in names else 1


def _fits(mesh, dim: int, *axes: str) -> bool:
    size = 1
    for a in axes:
        size *= axis_size(mesh, a)
    return size > 1 and dim % size == 0


def maybe(mesh, dim: int, *axes: str):
    """Return the axis (tuple) if the dim divides, else None (replicate)."""
    axes = tuple(a for a in axes if a in mesh.mesh_dim_names)
    if not axes:
        return None
    if _fits(mesh, dim, *axes):
        return axes if len(axes) > 1 else axes[0]
    # try a prefix (e.g. ('pod','data') -> ('data',))
    for i in range(len(axes) - 1, 0, -1):
        if _fits(mesh, dim, *axes[i:]):
            sub = axes[i:]
            return sub if len(sub) > 1 else sub[0]
    return None


def batch_axes(mesh, batch: int):
    return maybe(mesh, batch, "pod", "data")


# --------------------------------------------------------------------------
# parameter sharding
# --------------------------------------------------------------------------


def _param_spec(path: Tuple[str, ...], leaf, cfg: ArchConfig, mesh) -> Spec:
    """Spec for one parameter; `path` is the key path (strings)."""
    name = path[-1]
    scanned = "blocks" in path  # leading n_blocks axis
    shape = leaf.shape[1:] if scanned else leaf.shape

    def spec(*axes) -> Spec:
        return (None,) + axes if scanned else axes

    if name == "tokens":  # [V, D]
        s = spec(maybe(mesh, shape[0], "model"), maybe(mesh, shape[1], "data"))
    elif name == "unembed":  # [D, V]
        s = spec(maybe(mesh, shape[0], "data"), maybe(mesh, shape[1], "model"))
    elif name == "wq":  # [D, H, K]
        s = spec(maybe(mesh, shape[0], "data"), maybe(mesh, shape[1], "model"), None)
    elif name in ("wk", "wv"):  # [D, G, K] — G may be < model size (MQA)
        s = spec(maybe(mesh, shape[0], "data"), maybe(mesh, shape[1], "model"), None)
    elif name == "wo":  # [H, K, D]
        s = spec(maybe(mesh, shape[0], "model"), None, maybe(mesh, shape[2], "data"))
    elif name in ("w_up", "w_gate", "w_down") and len(shape) == 3:
        # MoE experts [E, D, F] / [E, F, D]: expert parallel on `model`.
        s = spec(maybe(mesh, shape[0], "model"), maybe(mesh, shape[1], "data"), None)
    elif name in ("w_up", "w_gate"):  # [D, F]
        s = spec(maybe(mesh, shape[0], "data"), maybe(mesh, shape[1], "model"))
    elif name == "w_down":  # [F, D]
        s = spec(maybe(mesh, shape[0], "model"), maybe(mesh, shape[1], "data"))
    elif name == "router":  # [D, E]
        s = spec(maybe(mesh, shape[0], "data"), None)
    elif name == "in_proj":  # mamba [D, Proj]
        s = spec(maybe(mesh, shape[0], "data"), maybe(mesh, shape[1], "model"))
    elif name == "out_proj":  # mamba [d_inner, D]
        s = spec(maybe(mesh, shape[0], "model"), maybe(mesh, shape[1], "data"))
    elif name in ("w1", "w2", "frontend_proj"):  # frontend projections
        s = spec(None, maybe(mesh, shape[1], "data"))
    else:
        s = spec(*(None,) * len(shape))  # norms, biases, A_log, ... replicate
    return s


def to_placements(spec: Spec, mesh) -> Placements:
    """DTensor placements of a spec: ``Shard(d)`` on every mesh dim that
    tensor dim ``d`` names, ``Replicate()`` on the others.  A dim over
    several axes must name them in the mesh's order, which makes DTensor's
    split major to minor, as JAX's is."""
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        idx = [names.index(a) for a in (axes if isinstance(axes, tuple) else (axes,))]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]} used twice")
            out[i] = Shard(d)
    return tuple(out)


def _by_path(tree: Any, one) -> Any:
    """``one(path, leaf)`` over the leaves of a tree, ``path`` the tuple of
    keys; a tree of the results in the tree's structure."""
    return unflatten(
        tree, [one(tuple(path.split("/")), leaf) for path, leaf in leaves_with_paths(tree)]
    )


def param_shardings(cfg: ArchConfig, params_tree: Any, mesh) -> Any:
    """Placements matching the params tree (on any device, meta too)."""
    return _by_path(
        params_tree, lambda path, leaf: to_placements(_param_spec(path, leaf, cfg, mesh), mesh)
    )


# --------------------------------------------------------------------------
# activation / batch / cache sharding
# --------------------------------------------------------------------------


def batch_spec(mesh, shape: Tuple[int, ...]) -> Spec:
    """Input batch leaf: the leading batch dim over ('pod','data')."""
    return (batch_axes(mesh, shape[0]),) + (None,) * (len(shape) - 1)


def batch_shardings(cfg: ArchConfig, batch_specs: Any, mesh) -> Any:
    return tree_map(lambda leaf: to_placements(batch_spec(mesh, leaf.shape), mesh), batch_specs)


def cache_spec(path: Tuple[str, ...], leaf, mesh) -> Spec:
    """KV/SSM cache leaf (with a leading n_blocks axis).

    attn k/v [n, B, W, G, K]: batch over ('pod','data') if divisible else
    W over 'data'; G over 'model' if divisible.
    mamba ssm [n, B, H, N, P]: batch over ('pod','data'), H on 'model'.
    """
    name = path[-1]
    shape = leaf.shape[1:]  # strip n_blocks
    if name in ("k", "v"):
        b = batch_axes(mesh, shape[0])
        g = maybe(mesh, shape[2], "model")
        w = None if b is not None else maybe(mesh, shape[1], "data")
        return (None, b, w, g, None)
    if name == "pos":  # [n, 1, W]
        return (None, None, None)
    if name == "ssm":  # [n, B, H, N, P]
        b = batch_axes(mesh, shape[0])
        h = maybe(mesh, shape[1], "model")
        return (None, b, h, None, None)
    if name == "conv":  # [n, B, k-1, Ch]
        b = batch_axes(mesh, shape[0])
        ch = maybe(mesh, shape[2], "model")
        return (None, b, None, ch)
    raise ValueError(f"unknown cache leaf {path}")


def cache_shardings(cfg: ArchConfig, cache_tree: Any, mesh) -> Any:
    return _by_path(cache_tree, lambda path, leaf: to_placements(cache_spec(path, leaf, mesh), mesh))


def replicated(mesh) -> Placements:
    return (Replicate(),) * len(mesh.mesh_dim_names)


def distribute(tree: Any, placements: Any, mesh) -> Any:
    """Each tensor of ``tree`` as a DTensor on ``mesh`` with the matching
    placements of ``placements`` (a tree of the same structure).  Every
    rank passes the same whole tensor (drawn from one seed, or read from
    one checkpoint) and keeps its own shard of it: nothing is sent, and
    no collective holds the tensors after the call."""
    return tree_map(
        lambda t, p: distribute_tensor(t, mesh, p, src_data_rank=None)
        if torch.is_tensor(t) else t,
        tree, placements,
    )


def constrain(t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """``t`` redistributed to ``spec`` when it is a DTensor (the port's
    ``with_sharding_constraint``); a plain tensor is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    want = to_placements(spec, t.device_mesh)
    return t if t.placements == want else t.redistribute(t.device_mesh, want)


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A plain tensor that every rank computes alike (positions, RoPE
    angles), as a replicated DTensor on ``like``'s mesh when ``like`` is
    a DTensor, so the two can meet in one op; else ``t`` itself."""
    if not isinstance(like, DTensor) or isinstance(t, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, replicated(mesh), run_check=False)


def gather_fsdp(tree: Any) -> Any:
    """FSDP's all-gather: every DTensor of ``tree`` with its shards over
    the batch axes ('pod', 'data') gathered, its `model` shards kept (the
    gathers the reference leaves to XLA; the backward reduce-scatters the
    grads).  Plain tensors pass as they are."""

    def one(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names
        want = tuple(Replicate() if names[i] in ("pod", "data") else p
                     for i, p in enumerate(t.placements))
        return t if want == t.placements else t.redistribute(t.device_mesh, want)

    return tree_map(one, tree)
