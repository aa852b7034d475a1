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
The expert-parallel ``apply_moe_shard_map`` is not ported (ROADMAP.md
queue A item 9).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
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


def route(router: torch.Tensor, cfg: ArchConfig, xt: torch.Tensor) -> Routing:
    """Top-k routing of ``xt [T, D]`` with capacity: a pair's slot is the
    number of pairs before it, in row-major (token, k) order, that chose
    the same expert; pairs with slot >= C are dropped."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, T)
    probs = torch.softmax(xt.float() @ router, dim=-1)
    top_p, top_i = torch.topk(probs, K, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    onehot = F.one_hot(top_i.reshape(T * K), E)  # [T*K, E]
    pos = ((onehot.cumsum(0) - 1) * onehot).sum(-1)
    keep = pos < C
    return Routing(probs, top_p, top_i, onehot.sum(0), torch.where(keep, pos, C), keep, C)


def apply_moe(p: Params, cfg: ArchConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B,S,D] in x's dtype, fp32 aux load-balance loss
    ``E * sum_e(frac_e * mean prob_e)``)."""
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, D)
    r = route(p["router"], cfg, xt)
    flat_e = r.top_i.reshape(T * K)

    # Switch aux loss: E * sum_e(token fraction_e * mean prob_e)
    aux = E * torch.sum(r.load.float() / (T * K) * r.probs.mean(0))

    # Dispatch into [E, C+1, D]: kept (expert, slot) pairs are unique, so
    # assignment is the reference's scatter-add; dropped pairs land in
    # scratch row C, sliced off.
    token_idx = torch.arange(T, device=x.device).repeat_interleave(K)
    buf = x.new_zeros((E, r.capacity + 1, D))
    buf = buf.index_put((flat_e, r.slot), xt[token_idx])[:, : r.capacity]

    # Grouped SwiGLU over every expert
    up = torch.bmm(buf, p["w_up"])
    gate = torch.bmm(buf, p["w_gate"])
    out = torch.bmm(F.silu(gate) * up, p["w_down"])  # [E, C, D]

    # Combine: each pair's expert output (row C = zeros for a dropped
    # pair), weighted, summed over the token's K pairs.  A sum over a
    # [T, K, D] view, not index_add_, whose CUDA adds come in no fixed
    # order.
    out_pad = torch.cat([out, out.new_zeros((E, 1, D))], dim=1)
    gathered = out_pad[flat_e, r.slot]  # [T*K, D]
    weights = (r.top_p.reshape(T * K) * r.keep).to(gathered.dtype)
    y = (gathered * weights[:, None]).view(T, K, D).sum(1)
    return y.view(B, S, D), aux
