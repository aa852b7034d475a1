"""Plain PyTorch versions of the port's kernels.

They mirror the JAX package's oracles (``repro/kernels/ref.py``) and are
what ``ops`` runs on CPU tensors; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # masked score: a fully masked row averages v, never NaN


def attention_mask(
    q_pos: torch.Tensor,  # [Sq] shared, or [B,Sq] per-row
    kv_pos: torch.Tensor,  # [T]; -1 marks an unwritten cache slot
    causal: bool,
    window: Optional[int],
) -> torch.Tensor:
    """Boolean ``[Sq,T]`` (or ``[B,Sq,T]``) mask: True where a query may
    attend a key.  Same semantics as ``repro.models.layers._mask_bias``."""
    qp = q_pos[..., :, None]
    ok = (kv_pos >= 0).expand(qp.shape[:-1] + kv_pos.shape)
    if causal:
        ok = ok & (kv_pos <= qp)
    if window is not None:
        ok = ok & (kv_pos > qp - window)
    return ok


def flash_attention_ref(
    q: torch.Tensor,  # [B,Sq,H,K]
    k: torch.Tensor,  # [B,T,G,K]
    v: torch.Tensor,  # [B,T,G,K]
    q_pos: torch.Tensor,  # [Sq] or [B,Sq]
    kv_pos: torch.Tensor,  # [T]
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """GQA attention in fp32 with scale ``K**-0.5``; output in q's dtype.

    Masked scores are -1e30 (not -inf), so a row with no visible key
    returns the mean of v over the T keys, as the JAX reference does.
    """
    B, Sq, H, K = q.shape
    G = k.shape[2]
    qg = q.reshape(B, Sq, G, H // G, K).float()
    s = torch.einsum("bsghk,btgk->bghst", qg, k.float()) * (K**-0.5)
    ok = attention_mask(q_pos, kv_pos, causal, window)
    ok = ok[None, None, None] if ok.ndim == 2 else ok[:, None, None]
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bghst,btgk->bsghk", p, v.float())
    return o.reshape(B, Sq, H, K).to(q.dtype)


def rmsnorm_ref(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` per row, in fp32; x's dtype out."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
