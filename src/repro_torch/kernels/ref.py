"""Plain PyTorch versions of the port's kernels.

They mirror the JAX package's oracles (``repro/kernels/ref.py``) and are
what ``ops`` runs on CPU tensors; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def ssd_scan_ref(
    x: torch.Tensor,  # [B,S,H,P]
    dt: torch.Tensor,  # [B,S,H] (softplus applied)
    A: torch.Tensor,  # [H], negative
    Bm: torch.Tensor,  # [B,S,N]
    Cm: torch.Tensor,  # [B,S,N]
    init_state: Optional[torch.Tensor] = None,  # [B,H,N,P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential SSD recurrence in fp32, one token at a time:
    ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t . h_t``.
    Returns (y [B,S,H,P] fp32, final state [B,H,N,P] fp32).  The tests'
    ground truth; O(S) Python steps, so no path of the port runs it."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, Bm, Cm))
    h = (
        init_state.float().clone()
        if init_state is not None
        else torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)
    )
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * A.float())  # [B,H]
        h = decay[:, :, None, None] * h + torch.einsum(
            "bh,bn,bhp->bhnp", dtf[:, t], Bf[:, t], xf[:, t]
        )
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(Bsz, 0, H, P)
    return y, h


def ssd_chunked_ref(
    x: torch.Tensor,  # [B,S,H,P]
    dt: torch.Tensor,  # [B,S,H] (softplus applied)
    A: torch.Tensor,  # [H], negative
    Bm: torch.Tensor,  # [B,S,N]
    Cm: torch.Tensor,  # [B,S,N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B,H,N,P]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD algorithm of ``repro.models.mamba.ssd_chunked``, in
    fp32: an intra-chunk quadratic term plus an inter-chunk state
    recurrence.  S is zero-padded to a chunk multiple (dt = 0 there, so the
    pad is a no-op).  Returns (y [B,S,H,P] fp32, final state [B,H,N,P]
    fp32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = (-S) % chunk
    xf, dtf, Bf, Cf = (
        torch.nn.functional.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, pad))
        for t in (x, dt, Bm, Cm)
    )
    nc = (S + pad) // chunk
    xc = xf.view(Bsz, nc, chunk, H, P)
    dtc = dtf.view(Bsz, nc, chunk, H)
    Bc = Bf.view(Bsz, nc, chunk, N)
    Cc = Cf.view(Bsz, nc, chunk, N)

    cum = torch.cumsum(dtc * A.float(), dim=2)  # [B,nc,Q,H], inclusive

    # intra-chunk: W[i,j] = (C_i.B_j) exp(cum_i - cum_j) dt_j for j <= i.
    # The mask selects before exp: exp(cum_i - cum_j) overflows for j > i.
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q(i),Q(j),H]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(tri[:, :, None], diff, torch.zeros_like(diff)))
    L = torch.where(tri[:, :, None], decay, torch.zeros_like(decay))
    W = CB[..., None] * L * dtc[:, :, None, :, :]
    y = torch.einsum("bcijh,bcjhp->bcihp", W, xc)

    # per-chunk states, then the recurrence over chunks
    cum_last = cum[:, :, -1:, :]
    states = torch.einsum(
        "bcjh,bcjn,bcjhp->bchnp", torch.exp(cum_last - cum) * dtc, Bc, xc
    )  # [B,nc,H,N,P]
    chunk_decay = torch.exp(cum_last[:, :, 0, :])  # [B,nc,H]
    h = (
        init_state.float()
        if init_state is not None
        else torch.zeros(Bsz, H, N, P, dtype=torch.float32, device=x.device)
    )
    y_off = []
    for c in range(nc):
        # y from the incoming state: C_t . (exp(cum_t) h)
        y_off.append(torch.einsum("bin,bhnp,bih->bihp", Cc[:, c], h, torch.exp(cum[:, c])))
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    y = y + torch.stack(y_off, dim=1)
    return y.reshape(Bsz, nc * chunk, H, P)[:, :S], h
