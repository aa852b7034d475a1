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

On DTensors (``_placed_mix``) the prefill's products and conv run on
`model`-split operands: z, x, (B, C) and dt are separate products with
column blocks of in_proj, each split over `model` (x on head boundaries),
so each weight gradient is a local product; the conv runs on each rank's
channels, and then B and C are gathered whole for the scan; y is split
again after the gated norm, so out_proj's product is row-parallel.  Under
``sp``, where `model` splits the sequence, the whole block runs on each
rank's sequence rows instead (``_rows_mix``, ``_gate_and_project_rows``),
as the reference's compiled step runs it.  Plain tensors take the code
path the JAX parity tests hold.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ArchConfig
from ..kernels import ops
from ..parallel import opt_flags
from ..parallel import sharding as sh
from ..dtensor_util import partial_where_split, product_with_gathered, unsplit
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


def _causal_conv(
    xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor, halo: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """silu of the depthwise causal conv over the sequence, in fp32.
    xbc [B,S,Ch], left-padded by ``halo`` [B,k-1,Ch], the k-1 rows before
    it (default zeros), w [k,Ch], b [Ch]."""
    k, (B, S, Ch) = w.shape[0], xbc.shape
    # zeros concatenated, not F.pad: DTensor's pad on a 2-D mesh gives a
    # result placed on one mesh dim (torch 2.11), which the next view rejects
    if halo is None:
        halo = xbc.new_zeros((B, k - 1, Ch), dtype=torch.float32)
    xp = torch.cat([halo.float(), xbc.float()], dim=1)
    wf = w.float()
    out = b.float() + xp[:, :S] * wf[0]
    for i in range(1, k):
        out = out + xp[:, i : i + S] * wf[i]
    return F.silu(out)


def _gate_and_project(
    p: Params, y: torch.Tensor, z: torch.Tensor
) -> torch.Tensor:
    """rms_norm(y * silu(z)) @ out_proj, for y and z [B,S,di] in x's dtype.
    On DTensors the normed y is split over `model` again (a local slice),
    so the product is row-parallel, as out_proj is placed: its output's
    partial sums are reduced over `model`, and out_proj's gradient is each
    rank's ``[di/model, D]``.  Under ``sp``, where `model` splits the
    sequence, the norm and the product run on each rank's sequence rows
    instead (``_gate_and_project_rows``)."""
    B, S, di = y.shape
    g = y * F.silu(z)
    if _on_rows(g):
        return _gate_and_project_rows(p, g)
    # the norm needs all of d_inner: gathered where tensor parallelism split it
    y = L.rms_norm(unsplit(g, -1), p["norm"])
    if isinstance(y, DTensor) and sh.maybe(y.device_mesh, di, "model"):
        y = _on_model(y, 2)
    out = (y.reshape(B * S, di) @ p["out_proj"]).view(B, S, -1)
    if isinstance(out, DTensor) and any(q.is_partial() for q in out.placements):
        out = out.redistribute(out.device_mesh, tuple(
            Replicate() if q.is_partial() else q for q in out.placements))
    return out


def _gate_and_project_rows(p: Params, g: DTensor) -> DTensor:
    """``_gate_and_project`` of the gated rows ``g [B,S,di]`` under ``sp``,
    split on the sequence as the reference places them: the norm on each
    rank's whole rows, and the product with out_proj gathered whole over
    `model` (a weight, gathered again for the backward:
    ``product_with_gathered``).  The output ``[B,S,D]`` is split as the
    ``sp`` residual is, with no partial sums; out_proj's gradient is each
    rank's partial sum over its rows, reduce-scattered to its split."""
    return product_with_gathered(L.rms_norm(g, p["norm"]), p["out_proj"])


def _on_rows(t: torch.Tensor) -> bool:
    """True for a DTensor ``t [B,S,...]`` under ``sp`` where `model`
    divides S: the Mamba block then runs on each rank's sequence rows."""
    return (isinstance(t, DTensor) and bool(opt_flags.get("sp"))
            and sh.maybe(t.device_mesh, t.shape[1], "model") is not None)


def _on_model(t: DTensor, dim: int) -> DTensor:
    """``t`` split on ``dim`` over `model`, its other mesh dims as they
    are; from a ``t`` whole on `model`, a local slice."""
    names = t.device_mesh.mesh_dim_names
    want = tuple(Shard(dim) if n == "model" else q for n, q in zip(names, t.placements))
    return t if want == t.placements else t.redistribute(t.device_mesh, want)


def _conv_on_ranks(t: DTensor, w: DTensor, b: DTensor) -> DTensor:
    """``_causal_conv`` of ``t [B,S,C]`` (in t's dtype) on each rank's
    rows and channels, ``w [k,C]`` and ``b [C]`` placed alike on the
    channels: the depthwise conv is channel-local.  The gradients of w and
    b are each rank's partial sums over its batch rows."""
    tp = t.placements
    over_batch = lambda q: tuple(  # noqa: E731
        Partial() if tq == Shard(0) else wq for tq, wq in zip(tp, q))
    return local_map(
        lambda a, w_, b_: _causal_conv(a, w_, b_).to(a.dtype),
        out_placements=(tp,), in_placements=(tp, w.placements, b.placements),
        in_grad_placements=(tp, over_batch(w.placements), over_batch(b.placements)),
        device_mesh=t.device_mesh,
    )(t, w, b)


def _placed_mix(p: Params, cfg: ArchConfig, x: DTensor):
    """The in_proj products and the causal conv of ``apply_mamba`` on
    DTensors, none whole on a device: x's rows over the batch axes, and z,
    x, (B, C) and dt each the product with its own column block of
    in_proj, split over `model` where it divides (z, x and dt where the
    heads do: x then on head boundaries, as the scan takes it).  The
    blocks come from in_proj gathered whole over `model` (a weight, not an
    activation); each block's gradient is a local product, and the leaf's
    gradient is the blocks' put back together, each rank keeping its own
    columns.  The conv runs on each rank's channels; then B and C are
    gathered whole, as every rank's heads read all of them.  Returns (z,
    xs, bc, dt_raw, x_pre, bc_pre): xs the conv's x channels, bc its B and
    C channels, x_pre and bc_pre the same before the conv."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    B, S, D = x.shape
    mesh = x.device_mesh
    x = sh.constrain(x, (sh.batch_axes(mesh, B), None, None))
    heads = sh.maybe(mesh, H, "model") is not None
    bc_split = sh.maybe(mesh, 2 * N, "model") is not None
    # where a block stays whole, a copy of it, unless in_proj was whole
    # already: a view would keep the gathered in_proj alive for the backward
    gathered = sh.axis_size(mesh, "model") > 1
    cut = lambda t, dim, ok: _on_model(t, dim) if ok else (  # noqa: E731
        t.contiguous() if gathered else t)
    xt = x.reshape(B * S, D)
    w_z, w_x, w_bc, w_dt = unsplit(p["in_proj"], 1).split([di, di, 2 * N, H], dim=1)
    z, x_pre, bc_pre, dt_raw = ((xt @ cut(w, 1, ok)).view(B, S, -1) for w, ok in (
        (w_z, heads), (w_x, heads), (w_bc, bc_split), (w_dt, heads)))
    (cw_x, cw_bc), (cb_x, cb_bc) = p["conv_w"].split([di, 2 * N], 1), p["conv_b"].split([di, 2 * N])
    xs = _conv_on_ranks(x_pre, cut(cw_x, 1, heads), cut(cb_x, 0, heads))
    bc = unsplit(_conv_on_ranks(bc_pre, cut(cw_bc, 1, bc_split), cut(cb_bc, 0, bc_split)), -1)
    return z, xs, bc, dt_raw, x_pre, bc_pre


def _rows_before(tails: torch.Tensor, r: int, n: int) -> torch.Tensor:
    """The ``n`` rows before the rows of rank ``r`` of a sequence split,
    from ``tails [m,B,t,Ch]``, each rank's last t rows (all its rows where
    it has fewer than n): zeros before the sequence."""
    m, B, t, Ch = tails.shape
    rows = torch.cat([tails.new_zeros((B, n, Ch)), tails[:r].transpose(0, 1).reshape(B, r * t, Ch)], 1)
    return rows[:, rows.shape[1] - n:]


def _conv_rows(t: DTensor, w: DTensor, b: DTensor):
    """``_causal_conv`` of ``t [B,S,Ch]`` split on its sequence (``sp``),
    in t's dtype, on each rank's rows with a halo: the k-1 rows before its
    first, zeros before the sequence, from an all-gather of every rank's
    last rows (all of them where it has fewer than k-1) and not of the
    sequence.  ``w [k,Ch]`` and ``b [Ch]`` are whole; their gradients are
    each rank's partial sums.  Returns (the conv placed as t, window):
    window() the sequence's last k-1 rows of t, whole on the sequence (a
    conv cache's window)."""
    k, (B, S, Ch) = w.shape[0], t.shape
    mesh, rows = t.device_mesh, t.placements
    seq = rows.index(Shard(1))
    r, m = mesh.get_coordinate()[seq], mesh.size(seq)
    n = min(k - 1, S // m)
    # each rank's last n rows, stacked in front of the batch: [m, B, n, Ch]
    per_rank = tuple(Shard(0) if q == Shard(1) else Shard(q.dim + 1) if q.is_shard() else q
                     for q in rows)
    tails = unsplit(local_map(lambda a: a[None, :, a.shape[1] - n:], out_placements=(per_rank,),
                              in_placements=(rows,), device_mesh=mesh)(t), 0)
    ins = (rows, tails.placements, w.placements, b.placements)
    out = local_map(
        lambda a, tl, w_, b_: _causal_conv(a, w_, b_, _rows_before(tl, r, k - 1)).to(a.dtype),
        out_placements=(rows,), in_placements=ins,
        in_grad_placements=tuple(partial_where_split(q, rows) for q in ins), device_mesh=mesh,
    )(t, tails, w, b)
    whole = tuple(Replicate() if q == Shard(1) else q for q in rows)
    window = lambda: local_map(  # noqa: E731
        lambda tl: _rows_before(tl, m, k - 1), out_placements=(whole,),
        in_placements=(tails.placements,), device_mesh=mesh)(tails)
    return out, window


def _rows_mix(p: Params, cfg: ArchConfig, x: DTensor):
    """The in_proj product and the causal conv of ``apply_mamba`` on each
    rank's sequence rows ``[B/data, S/model, D]`` (``sp``), as the
    reference's compiled step runs them: the product with in_proj gathered
    whole (``product_with_gathered``: a weight, never saved whole), z, the
    pre-conv x, B, C and dt the local columns of its output (as
    ``_split_proj`` cuts them, z a product of its own), and the conv on the
    rows with a halo (``_conv_rows``).  Returns (z, xh, B, C, dt_raw, window), window() the
    sequence's last k-1 pre-conv rows (the cache's conv window)."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    mesh = x.device_mesh
    x = sh.constrain(x, (sh.batch_axes(mesh, x.shape[0]), "model", None))
    rows = x.placements
    on_rows = lambda f, n, t: local_map(  # noqa: E731
        f, out_placements=(rows,) * n, in_placements=(rows,), device_mesh=mesh)(t)
    # z its own product: the gate keeps it for the backward, and the rest
    # need not be kept with it
    z, rest = product_with_gathered(x, p["in_proj"], (di, p["in_proj"].shape[1] - di))
    xbc_pre, dt_raw = on_rows(lambda a: (a[..., : di + 2 * N], a[..., di + 2 * N :]), 2, rest)
    xbc, window = _conv_rows(xbc_pre, p["conv_w"], p["conv_b"])
    xh, Bm, Cm = on_rows(lambda c: (c[..., :di].unflatten(-1, (H, P)), c[..., di : di + N],
                                    c[..., di + N :]), 3, xbc)
    return z, xh, Bm, Cm, dt_raw, window


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
    if _on_rows(x):
        z, xh, Bm, Cm, dt_raw, window = _rows_mix(p, cfg, x)
        tail = lambda s0: window()[:, s0 - S + cfg.ssm_conv - 1 :]  # noqa: E731
    elif isinstance(x, DTensor):
        z, xs, bc, dt_raw, x_pre, bc_pre = _placed_mix(p, cfg, x)
        xh, Bm, Cm = xs.view(B, S, H, P), bc[..., :N], bc[..., N:]
        tail = lambda s0: torch.cat([x_pre[:, s0:], bc_pre[:, s0:]], dim=-1)  # noqa: E731
    else:
        proj = (x.reshape(B * S, D) @ p["in_proj"]).view(B, S, -1)
        z, xbc_pre, dt_raw = _split_proj(cfg, proj)
        xbc = _causal_conv(xbc_pre, p["conv_w"], p["conv_b"]).to(x.dtype)
        xh = xbc[..., :di].view(B, S, H, P)  # strided views: the kernel reads
        Bm = xbc[..., di : di + N]  # them in place
        Cm = xbc[..., di + N :]
        tail = lambda s0: xbc_pre[:, s0:]  # noqa: E731
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
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
        conv[:, conv.shape[1] - n :].copy_(tail(S - n))
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
