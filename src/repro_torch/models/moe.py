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
On DTensors the same code runs op by op (``moe_ep`` pins the slabs to
`model`), or, under ``moe_a2a``, the expert-parallel
``apply_moe_shard_map``.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ArchConfig
from ..parallel import opt_flags
from ..parallel.sharding import constrain, replicate_like, replicated, to_placements
from . import layers as L

Params = Dict[str, Any]


def moe_spec(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """Shape and init of each MoE leaf (see ``layers.init_from_spec``).
    The expert leaves are drawn a leading slice at a time: stacked at
    full width each is ``[n_layers, E, D, F]``."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ((D, E), ("normal_fp32", D**-0.5)),
        "w_up": ((E, D, F_), ("normal_by_slice", D**-0.5)),
        "w_gate": ((E, D, F_), ("normal_by_slice", D**-0.5)),
        "w_down": ((E, F_, D), ("normal_by_slice", F_**-0.5)),
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


def route(
    router: torch.Tensor, cfg: ArchConfig, xt: torch.Tensor,
    experts: Optional[Tuple[int, int]] = None,
) -> Routing:
    """Top-k routing of ``xt [T, D]`` with capacity: a pair's slot is the
    number of pairs before it, in row-major (token, k) order, that chose
    the same expert; pairs with slot >= C are dropped.  ``experts`` =
    (first, count) routes to those experts alone (a rank's own under
    expert parallelism): a pair to any other is dropped, and slabs are
    numbered from ``first``."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, T)
    probs = torch.softmax(xt.float() @ router, dim=-1)
    top_p, top_i = torch.topk(probs, K, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    flat_e = top_i.reshape(T * K)
    onehot = F.one_hot(flat_e, E)  # [T*K, E]
    expert, mine, slab_hot = flat_e, None, onehot
    if experts is not None:
        first, count = experts
        mine = (flat_e >= first) & (flat_e < first + count)
        expert = torch.where(mine, flat_e - first, 0)
        slab_hot = F.one_hot(expert, count) * mine[:, None]
    pos = ((slab_hot.cumsum(0) - 1) * slab_hot).sum(-1)
    keep = pos < C if mine is None else mine & (pos < C)
    return Routing(probs, top_p, top_i, onehot.sum(0), torch.where(keep, pos, C), keep, C, expert)


def _aux(r: Routing, cfg: ArchConfig) -> torch.Tensor:
    """Switch aux loss: E * sum_e(token fraction_e * mean prob_e)."""
    T, K = r.top_i.shape
    return cfg.n_experts * torch.sum(r.load.float() / (T * K) * r.probs.mean(0))


def _experts(p: Params, xt: torch.Tensor, r: Routing, n_slabs: int) -> torch.Tensor:
    """Dispatch, grouped SwiGLU and combine: ``[T, D]``, each token's kept
    pairs' expert outputs weighted and summed."""
    T, D = xt.shape
    K = r.top_i.shape[1]
    # Dispatch into [n, C+1, D]: kept (slab, slot) pairs are unique, so
    # assignment is the reference's scatter-add; dropped pairs land in
    # scratch row C, sliced off.
    token_idx = replicate_like(torch.arange(T, device=xt.device).repeat_interleave(K), xt)
    buf = xt.new_zeros((n_slabs, r.capacity + 1, D))
    buf = buf.index_put((r.expert, r.slot), xt[token_idx])[:, : r.capacity]
    if opt_flags.get("moe_ep"):
        # pin the dispatch slabs to expert parallelism (a no-op on a
        # plain tensor, as inside the expert-parallel path)
        buf = constrain(buf, ("model", None, None))

    # Grouped SwiGLU over every slab
    up = torch.bmm(buf, p["w_up"])
    gate = torch.bmm(buf, p["w_gate"])
    out = torch.bmm(F.silu(gate) * up, p["w_down"])  # [n, C, D]
    if opt_flags.get("moe_ep"):
        out = constrain(out, ("model", None, None))

    # Combine: each pair's expert output (row C = zeros for a dropped
    # pair), weighted, summed over the token's K pairs.  A sum over a
    # [T, K, D] view, not index_add_, whose CUDA adds come in no fixed
    # order.
    out_pad = torch.cat([out, out.new_zeros((n_slabs, 1, D))], dim=1)
    gathered = out_pad[r.expert, r.slot]  # [T*K, D]
    weights = (r.top_p.reshape(T * K) * r.keep).to(gathered.dtype)
    return (gathered * weights[:, None]).view(T, K, D).sum(1)


def apply_moe(p: Params, cfg: ArchConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B,S,D] in x's dtype, fp32 aux load-balance loss
    ``E * sum_e(frac_e * mean prob_e)``).  Under the ``moe_a2a`` flag, with
    a mesh set, the expert-parallel ``apply_moe_shard_map``."""
    if opt_flags.get("moe_a2a") and opt_flags.get("mesh") is not None:
        return apply_moe_shard_map(p, cfg, x, opt_flags.get("mesh"), opt_flags.get("batch_axes"))
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    r = route(p["router"], cfg, xt)
    return _experts(p, xt, r, cfg.n_experts).view(B, S, D), _aux(r, cfg)


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
