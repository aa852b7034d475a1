"""Mamba2 (SSD) mixer of the port (the JAX package's ``repro/models/mamba.py``).

Recurrence per head (state N, head dim P), single B/C group:
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t        (A < 0)
    y_t = C_t . h_t + D x_t

Prefill runs the chunked scan through ``kernels.ops.ssd_scan`` (the
hand-written kernel on a CUDA tensor) and the gated norm through
``ops.rmsnorm``; decode is the single-token recurrence in plain torch, as
in the reference.  Layouts are the JAX package's:

  in_proj [D, 2*di + 2N + H]   (z ++ x ++ B ++ C ++ dt)
  conv_w [k, Ch], conv_b [Ch]  (Ch = di + 2N: x ++ B ++ C)
  cache: conv [B, k-1, Ch] (the last k-1 pre-conv rows), ssm [B, H, N, P] fp32

The cache is written in place.  Unlike the reference, the conv window of a
prompt shorter than k-1 tokens is left-padded with zeros, the padding the
causal conv itself applies (ROADMAP.md, C1).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..configs.base import ArchConfig
from ..kernels import ops
from ..parallel import opt_flags
from ..parallel import sharding as sh
from ..dtensor_util import unsplit
from . import layers as L

Params = Dict[str, Any]


def mamba_spec(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """Shape and init of each Mamba leaf (see ``layers.init_from_spec``)."""
    D, di = cfg.d_model, cfg.d_inner
    H, N, k = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv
    ch = di + 2 * N
    return {
        "in_proj": ((D, 2 * di + 2 * N + H), D**-0.5),
        "conv_w": ((k, ch), k**-0.5),
        "conv_b": ((ch,), "zeros"),
        "dt_bias": ((H,), ("softplus_inv_uniform", 1e-3, 1e-1)),
        "A_log": ((H,), ("log_uniform", 1.0, 16.0)),
        "D": ((H,), None),
        "norm": ((di,), None),
        "out_proj": ((di, D), di**-0.5),
    }


def init_mamba(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return L.init_from_spec(gen, mamba_spec(cfg), L.dtype_of(cfg))


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    """(z, xBC, dt) views of the in_proj output."""
    di, N = cfg.d_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di : 2 * di + 2 * N], proj[..., 2 * di + 2 * N :]


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """silu of the depthwise causal conv over the sequence, in fp32.
    xbc [B,S,Ch] (zero-padded by k-1 on the left), w [k,Ch], b [Ch]."""
    k, (B, S, Ch) = w.shape[0], xbc.shape
    # zeros concatenated, not F.pad: DTensor's pad on a 2-D mesh gives a
    # result placed on one mesh dim (torch 2.11), which the next view rejects
    xp = torch.cat([xbc.new_zeros((B, k - 1, Ch), dtype=torch.float32), xbc.float()], dim=1)
    wf = w.float()
    out = b.float() + xp[:, :S] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i : i + S] * wf[i]
    return F.silu(out)


def _gate_and_project(
    p: Params, y: torch.Tensor, z: torch.Tensor
) -> torch.Tensor:
    """rms_norm(y * silu(z)) @ out_proj, for y and z [B,S,di] in x's dtype."""
    B, S, di = y.shape
    # the norm needs all of d_inner: gathered where tensor parallelism split it
    y = L.rms_norm(unsplit(y * F.silu(z), -1), p["norm"])
    return (y.reshape(B * S, di) @ p["out_proj"]).view(B, S, -1)


def apply_mamba(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B,S,D]
    cache: Optional[Params] = None,
) -> torch.Tensor:
    """Mamba2 block over a whole sequence (prefill).  If ``cache`` is given,
    its conv window and ssm state are overwritten in place with the state
    after the last token."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    B, S, D = x.shape
    proj = (x.reshape(B * S, D) @ p["in_proj"]).view(B, S, -1)
    z, xbc_pre, dt_raw = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc_pre, p["conv_w"], p["conv_b"]).to(x.dtype)
    xh = xbc[..., :di].view(B, S, H, P)  # strided views: the kernel reads
    Bm = xbc[..., di : di + N]  # them in place
    Cm = xbc[..., di + N :]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    if opt_flags.get("mamba_heads") and isinstance(xh, DTensor) \
            and sh.maybe(xh.device_mesh, H, "model"):
        # the reference's sharding constraint: the scan's heads split over
        # `model`, so its per-chunk buffers shrink with the TP degree
        b = opt_flags.get("batch_axes")
        xh = sh.constrain(xh, (b, None, "model", None))
        dt = sh.constrain(dt, (b, None, "model"))
    y, state = ops.ssd_scan(xh, dt, A, Bm, Cm, cfg.ssm_chunk, out_dtype=torch.float32)
    # the D skip in fp32, then x's dtype (as the reference orders it)
    y = (y + p["D"][:, None] * xh.float()).reshape(B, S, di).to(x.dtype)
    out = _gate_and_project(p, y, z)

    if cache is not None:
        # The conv window: the last k-1 pre-conv rows, left-padded with
        # zeros when the prompt is shorter (ROADMAP.md, C1).
        conv = cache["conv"]
        n = min(S, conv.shape[1])
        conv[:, : conv.shape[1] - n].zero_()
        conv[:, conv.shape[1] - n :].copy_(xbc_pre[:, S - n :])
        cache["ssm"].copy_(state)
    return out


def apply_mamba_decode(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B,1,D]
    cache: Params,
) -> torch.Tensor:
    """One token of the recurrence (O(1) in sequence length), in plain
    torch as in the reference; the cache is updated in place."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    B = x.shape[0]
    proj = x[:, 0] @ p["in_proj"]  # [B, E]
    z, xbc_new, dt_raw = _split_proj(cfg, proj)
    conv, h = cache["conv"], cache["ssm"]
    window = torch.cat([conv, xbc_new[:, None].to(conv.dtype)], dim=1)  # [B,k,Ch]
    conv_out = (window.float() * p["conv_w"].float()).sum(dim=1) + p["conv_b"].float()
    xbc = F.silu(conv_out).to(x.dtype)  # [B,Ch]

    xh = xbc[:, :di].reshape(B, H, P).float()
    Bm = xbc[:, di : di + N].float()
    Cm = xbc[:, di + N :].float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"])  # [B,H]
    decay = torch.exp(dt * -torch.exp(p["A_log"]))
    h_new = decay[:, :, None, None] * h + torch.einsum("bh,bn,bhp->bhnp", dt, Bm, xh)
    y = torch.einsum("bn,bhnp->bhp", Cm, h_new) + p["D"][:, None] * xh
    out = _gate_and_project(p, y.reshape(B, 1, di).to(x.dtype), z[:, None])

    h.copy_(h_new)
    conv.copy_(window[:, 1:])
    return out


def init_mamba_cache(
    cfg: ArchConfig, batch: int, dtype: torch.dtype, device
) -> Params:
    ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, ch), dtype=dtype, device=device),
        "ssm": torch.zeros(
            (batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
            dtype=torch.float32, device=device,
        ),
    }
