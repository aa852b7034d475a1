"""AdamW, its schedule and int8 gradient compression, in the JAX package's
arithmetic (``repro/train/optimizer.py``).

Moments are fp32 trees of the params' structure.  ``adamw_update`` runs
under ``torch.no_grad()`` and updates params, ``m`` and ``v`` in place (the
JAX version returns new trees), which keeps the temporaries to a few fp32
copies of one leaf at a time; it returns the same trees.  Every scalar
(the step, the learning rate, the clip scale, the bias corrections) stays
a tensor on the params' device, so a step reads nothing back to the host.

Weight decay applies to every leaf with ``ndim >= 2``, as in the
reference.  In the stacked parameter tree that is every per-block norm
scale (``blocks/sub*/ln1`` is ``[n_blocks, D]``) and Mamba's ``A_log``,
``D``, ``dt_bias``, ``conv_b`` and ``norm`` too; only ``final_norm`` is
exempt.  The port keeps the rule as it is, for parity.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..tree import leaves, tree_map, unflatten

Params = Any


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Params  # fp32, same tree as params
    v: Params  # fp32


@dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then a cosine to 0 at
    ``total_steps``; fp32."""
    step = step.float()
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0,
        1.0,
    )
    cos = 0.5 * cfg.lr_peak * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Params) -> torch.Tensor:
    """fp32 L2 norm over every leaf, summed in ``leaves`` order."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def adamw_init(params: Params) -> AdamWState:
    """Zero moments and step 0, on the params' device."""
    zeros = zeros_like_error(params)
    dev = leaves(params)[0].device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=zeros,
        v=tree_map(torch.clone, zeros),
    )


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig,
    params: Params,
    grads: Params,
    state: AdamWState,
) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping; params, ``m`` and ``v``
    are updated in place.  Returns (params, new state, {"grad_norm" (before
    clipping), "lr"})."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m), leaves(state.v)):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g * g)
        delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        if p.ndim >= 2:  # decay matrices only (in the reference's sense)
            delta.add_(cfg.weight_decay * p.float())
        p.copy_(p.float().sub_(lr * delta))
    return params, AdamWState(step=step, m=state.m, v=state.v), {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------------------
# int8 gradient compression with error feedback
# --------------------------------------------------------------------------


def compress(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization; returns (q, scale).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    absmax = torch.max(torch.abs(g)) + 1e-12
    scale = absmax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


@torch.no_grad()
def compress_decompress_with_feedback(grads: Params, error: Params) -> Tuple[Params, Params]:
    """Quantize grads + error to int8 and back; returns (grads_hat in the
    grads' dtypes, new error in fp32)."""

    def one(g, e):
        target = g.float() + e
        ghat = decompress(*compress(target))
        return ghat.to(g.dtype), target - ghat

    outs = [one(g, e) for g, e in zip(leaves(grads), leaves(error))]
    return unflatten(grads, [o[0] for o in outs]), unflatten(grads, [o[1] for o in outs])


def zeros_like_error(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
