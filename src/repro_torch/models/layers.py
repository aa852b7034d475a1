"""Dense-decoder layers of the port: RMSNorm, RoPE, GQA attention with a KV
cache, gated and plain MLP, embeddings, the cross-entropy loss.  Plain
functions on dicts of tensors, in the JAX package's layouts
(``repro/models/layers.py``):

  x            [B, S, D]
  q            [B, S, H, K]      (K = head_dim)
  k, v         [B, T, G, K]      (G = kv heads)
  wq [D,H,K]   wk, wv [D,G,K]    wo [H,K,D]
  w_up, w_gate [D,F]   w_down [F,D]   tokens [V,D]   unembed [D,V]

Weights live in ``cfg.dtype``; norm scales, softmax, norm statistics and
the loss are fp32.  RMSNorm and attention go through ``kernels.ops``: on
CUDA tensors they launch the hand-written kernels, on CPU tensors they
run the plain versions.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ArchConfig
from ..kernels import ops
from ..dtensor_util import local_range, unsplit
from ..parallel.sharding import replicate_like

Params = Dict[str, Any]
CacheIndex = Union[int, torch.Tensor, None]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def normal(
    gen: torch.Generator, shape: Tuple[int, ...], std: float, dtype: torch.dtype,
    device=None,
) -> torch.Tensor:
    """Seeded N(0, std^2) draw, taken in fp32 on ``device`` (default: the
    generator's) and cast to ``dtype`` (the JAX init's order of
    operations)."""
    w = torch.randn(shape, generator=gen, device=device or gen.device, dtype=torch.float32)
    return w.mul_(std).to(dtype)


def init_from_spec(
    gen: torch.Generator, spec: Any, dtype: torch.dtype, device=None
) -> Any:
    """Params for a (nested) spec of ``(shape, init)`` leaves, drawn in the
    spec's order on ``device`` (default: the generator's; ``"meta"`` gives
    shapes and dtypes only).  ``init`` is one of:

    * a float std: a seeded normal draw in ``dtype``;
    * None: fp32 ones (norm scales, Mamba's D skip);
    * "zeros": zeros in ``dtype`` (the conv bias);
    * ("normal_fp32", std): a seeded normal draw kept in fp32 whatever
      ``dtype`` is (the MoE router);
    * ("normal_by_slice", std): a seeded normal draw in ``dtype``, taken one
      leading slice at a time, so the fp32 scratch is one slice, not the
      leaf (the stacked MoE expert weights: a full-width leaf in fp32 would
      not fit beside the model);
    * ("log_uniform", lo, hi): fp32 ``log(U[lo, hi])`` (Mamba's A_log);
    * ("softplus_inv_uniform", lo, hi): fp32 ``log(expm1(U[lo, hi]))``, the
      inverse softplus of a uniform draw (Mamba's dt bias).
    """
    if isinstance(spec, dict):
        return {k: init_from_spec(gen, v, dtype, device) for k, v in spec.items()}
    shape, init = spec
    dev = gen.device if device is None else torch.device(device)
    if init is None:
        return torch.ones(shape, dtype=torch.float32, device=dev)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if isinstance(init, tuple) and init[0] == "normal_fp32":
        return normal(gen, shape, init[1], torch.float32, dev)
    if isinstance(init, tuple) and init[0] == "normal_by_slice":
        out = torch.empty(shape, dtype=dtype, device=dev)
        for part in out:
            part.copy_(normal(gen, shape[1:], init[1], dtype, dev))
        return out
    if isinstance(init, tuple):
        kind, lo, hi = init
        u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
        u = u.mul_(hi - lo).add_(lo)
        if kind == "log_uniform":
            return torch.log(u)
        if kind == "softplus_inv_uniform":
            return torch.log(torch.expm1(u))
        raise ValueError(f"unknown init kind {kind!r}")
    return normal(gen, shape, init, dtype, dev)


# --------------------------------------------------------------------------
# norms / rope
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return ops.rmsnorm(x.contiguous(), scale, eps)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: [B,S,H,K]; positions: [S] or [B,S].  Angles in
    fp32; the result is cast back to x's dtype."""
    K = x.shape[-1]
    half = K // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device)
        / half
    )
    pos = positions.to(torch.float32)
    if positions.ndim == 1:
        angles = pos[None, :, None] * freqs[None, None, :]
    else:
        angles = pos[:, :, None] * freqs[None, None, :]
    angles = angles[:, :, None, :]  # [1 or B, S, 1, half]
    cos, sin = replicate_like(torch.cos(angles), x), replicate_like(torch.sin(angles), x)
    x1, x2 = x[..., :half], x[..., half : 2 * half]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    out = torch.cat([rx1, rx2, x[..., 2 * half :].to(rx1.dtype)], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


def attention_spec(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], Optional[float]]]:
    """Shape and init std of each attention leaf (None: fp32 ones)."""
    D, H, G, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spec = {
        "wq": ((D, H, K), D**-0.5),
        "wk": ((D, G, K), D**-0.5),
        "wv": ((D, G, K), D**-0.5),
        "wo": ((H, K, D), (H * K) ** -0.5),
    }
    if cfg.qk_norm:
        spec["q_norm"] = ((K,), None)
        spec["k_norm"] = ((K,), None)
    return spec


def init_attention(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return init_from_spec(gen, attention_spec(cfg), dtype_of(cfg))


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,D] @ w [D,A,K] -> [B,S,A,K], contiguous."""
    B, S, D = x.shape
    return (x.reshape(B * S, D) @ w.reshape(D, -1)).view(B, S, *w.shape[1:])


def _write_cache(
    cache: Params,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    cache_index: CacheIndex,
    window: Optional[int],
) -> None:
    """Write the new k/v and their positions into ``cache`` in place (the
    JAX version returns a new pytree instead)."""
    if isinstance(cache["k"], DTensor):
        return _write_sharded_cache(cache, k, v, q_pos, cache_index, window)
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    W = ck.shape[1]  # buffer length (ring if SWA)
    B, S = k.shape[:2]
    if torch.is_tensor(cache_index) and cache_index.ndim == 1:
        # Per-row decode (batched serving: rows at different depths in one
        # batch).  Each row writes its single new k/v at its own slot; the
        # shared ``pos`` leaf stays consistent because with no sliding
        # window slot == absolute position for every row, and rows writing
        # the same slot write the same position value.
        if window is not None:
            raise ValueError("per-row cache positions require sliding_window=None")
        slots = cache_index.long()
        bidx = torch.arange(B, device=k.device)
        ck[bidx, slots] = k[:, 0].to(ck.dtype)
        cv[bidx, slots] = v[:, 0].to(cv.dtype)
        cpos[0, slots] = q_pos[:, 0].to(torch.int32)
    elif S >= W:
        # Prefill overflowing a ring buffer: keep the last W entries.
        # Ring-slot invariant (slot == pos % W) needs S % W == 0.
        if S % W:
            raise ValueError("SWA prefill length must be a multiple of W")
        ck.copy_(k[:, -W:])
        cv.copy_(v[:, -W:])
        cpos.copy_(q_pos[-W:].to(torch.int32)[None, :])
    else:
        slot = cache_index % W if window is not None else cache_index
        # dynamic_update_slice semantics: the start clamps so the update
        # fits.  A tensor slot stays on the device (no host sync).
        if torch.is_tensor(slot):
            idx = torch.clamp(slot, 0, W - S) + torch.arange(S, device=k.device)
        else:
            start = min(max(slot, 0), W - S)
            idx = torch.arange(start, start + S, device=k.device)
        ck.index_copy_(1, idx, k.to(ck.dtype))
        cv.index_copy_(1, idx, v.to(cv.dtype))
        cpos.index_copy_(1, idx, q_pos.to(torch.int32)[None, :])


def _write_sharded_cache(
    cache: Params,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    cache_index: CacheIndex,
    window: Optional[int],
) -> None:
    """``_write_cache`` on each rank's shard of a DTensor cache (DTensor's
    own index_copy_ would gather the cache): the new k/v are first placed
    as the cache's batch and heads.  A cache split on its slots takes, on
    each rank, the new rows whose slots it holds; their slots come from
    host integers, so such a cache needs a Python int ``cache_index``."""
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    if cpos.placements != tuple(Replicate() for _ in cpos.placements):
        raise ValueError(f"cache positions must be replicated, got {cpos.placements}")
    mesh = ck.device_mesh
    want = [Replicate() if p == Shard(1) else p for p in ck.placements]
    k, v = k.redistribute(mesh, want).to_local(), v.redistribute(mesh, want).to_local()
    lk, lv, lpos = ck.to_local(), cv.to_local(), cpos.full_tensor()
    if Shard(1) not in ck.placements:
        b0, b1 = local_range(ck, 0)
        if q_pos.ndim == 2:  # per-row decode: this rank's rows
            q_pos, cache_index = q_pos[b0:b1], cache_index[b0:b1]
        _write_cache({"k": lk, "v": lv, "pos": lpos}, k, v, q_pos, cache_index, window)
    else:
        if not isinstance(cache_index, int):
            raise ValueError("a cache split on its slots needs a Python int cache_index")
        W, S = ck.shape[1], k.shape[1]
        w0, w1 = local_range(ck, 1)
        if S >= W:  # the last W rows fill the buffer, row S - W + j in slot j
            if S % W:
                raise ValueError("SWA prefill length must be a multiple of W")
            start, k, v, q_pos = 0, k[:, -W:], v[:, -W:], q_pos[-W:]
        else:
            slot = cache_index % W if window is not None else cache_index
            start = min(max(slot, 0), W - S)
        lo, hi = max(start, w0), min(start + k.shape[1], w1)
        if lo < hi:
            lk[:, lo - w0 : hi - w0] = k[:, lo - start : hi - start].to(lk.dtype)
            lv[:, lo - w0 : hi - w0] = v[:, lo - start : hi - start].to(lv.dtype)
        lpos[:, start : start + k.shape[1]] = q_pos.to(torch.int32)[None, :]
    cpos.to_local().copy_(lpos)


def apply_attention(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # [B,S,D]
    q_pos: torch.Tensor,  # [S], or [B,1] per-row decode positions
    cache: Optional[Params] = None,
    cache_index: CacheIndex = None,
    self_attend: bool = True,
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Attention sublayer.

    ``cache`` given + ``self_attend``  : prefill — attend over the local
        k/v and write them into the cache.
    ``cache`` given + not self_attend  : decode — write the new k/v at
        ``cache_index`` (a scalar, or one slot per row) and attend over the
        buffer.
    no cache                           : plain self-attention.

    The cache is updated in place and returned (the same dict).
    """
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, q_pos, cfg.rope_theta)

    window = cfg.sliding_window
    if cache is not None:
        _write_cache(cache, k, v, q_pos, cache_index, window)
    if cache is None or self_attend:
        out = ops.flash_attention(q, k, v, q_pos, q_pos, cfg.causal, window)
    else:
        out = ops.flash_attention(
            q, cache["k"], cache["v"], q_pos, cache["pos"][0], cfg.causal, window
        )
    B, S, H, K = out.shape
    out = out.reshape(B * S, H * K) @ p["wo"].reshape(H * K, -1)
    return out.view(B, S, -1), cache


def init_attn_cache(
    cfg: ArchConfig, batch: int, max_len: int, dtype: torch.dtype, device
) -> Params:
    W = max_len if cfg.sliding_window is None else min(max_len, cfg.sliding_window)
    G, K = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, W, G, K), dtype=dtype, device=device),
        "v": torch.zeros((batch, W, G, K), dtype=dtype, device=device),
        # -1 marks unwritten slots; [1, W] as in the JAX cache.
        "pos": torch.full((1, W), -1, dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------


def mlp_spec(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    D, F_ = cfg.d_model, cfg.d_ff
    spec = {"w_up": ((D, F_), D**-0.5), "w_down": ((F_, D), F_**-0.5)}
    if cfg.mlp_gated:
        spec["w_gate"] = ((D, F_), D**-0.5)
    return spec


def init_mlp(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return init_from_spec(gen, mlp_spec(cfg), dtype_of(cfg))


def apply_mlp(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    up = x @ p["w_up"]
    if cfg.mlp_gated:
        h = F.silu(x @ p["w_gate"]) * up
    else:
        h = F.gelu(up, approximate="tanh")  # jax.nn.gelu's default
    return h @ p["w_down"]


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------


def embedding_spec(cfg: ArchConfig) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    V, D = cfg.padded_vocab, cfg.d_model
    spec = {"tokens": ((V, D), 0.02)}
    if not cfg.tie_embeddings:
        spec["unembed"] = ((D, V), D**-0.5)
    return spec


def init_embedding(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return init_from_spec(gen, embedding_spec(cfg), dtype_of(cfg))


def embed_tokens(p: Params, tokens: torch.Tensor) -> torch.Tensor:
    return p["tokens"][tokens]


def unembed(p: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ p["tokens"].T
    return x @ p["unembed"]


class _TakeLast(torch.autograd.Function):
    """``x[..., idx]`` for ``idx`` of x's shape less its last axis.  The
    backward scatters into zeros in place, as autograd's own gather
    backward does unless a dispatch mode is active, when it scatters out
    of place into one more buffer of x's size: the dry run's counting mode
    would then see a peak that the run itself does not reach.  x is not
    kept for the backward, only its shape."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return torch.gather(x, -1, idx[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return out.scatter_add_(-1, idx[..., None], g[..., None]), None


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last axis.  On a DTensor, as the max and the
    sum of exponentials, each reduced over the vocabulary's shards:
    DTensor's own logsumexp would first gather the batch."""
    if not isinstance(logits, DTensor):
        return torch.logsumexp(logits, dim=-1)
    m = unsplit(logits.amax(dim=-1, keepdim=True).detach(), -1)  # its gradient cancels
    s = unsplit(torch.exp(logits - m).sum(-1, keepdim=True), -1)
    return (m + torch.log(s))[..., 0]


def _gold_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logits[..., labels]``.  On a DTensor each rank gathers from its own
    shard of the vocabulary (zeros for labels outside it) and the ranks'
    parts are summed: DTensor's own gather would first gather the batch."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    mesh, lp = logits.device_mesh, logits.placements
    v0, v1 = local_range(logits, logits.ndim - 1)
    vocab = Shard(logits.ndim - 1)
    want = [Replicate() if p == vocab else p for p in lp]
    labels = replicate_like(labels, logits)
    labels = labels.redistribute(mesh, want) if labels.placements != tuple(want) else labels

    def local(lg, lb):
        inside = (lb >= v0) & (lb < v1)
        return _TakeLast.apply(lg, torch.where(inside, lb - v0, 0)) * inside

    gold = local_map(
        local, out_placements=[Partial() if p == vocab else p for p in lp],
        in_placements=(lp, tuple(want)), device_mesh=mesh,
    )(logits, labels)
    return gold.redistribute(mesh, want)


def cross_entropy(
    logits: torch.Tensor,  # [B,S,V]
    labels: torch.Tensor,  # [B,S]; -1 = ignore
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked mean NLL, token count), both fp32 scalars; labels of -1
    count for nothing, and the count is at least 1."""
    logits = logits.float()
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0).long()
    lse = _logsumexp(logits)
    gold = _gold_logits(logits, safe)
    nll = (lse - gold) * mask
    denom = mask.sum().clamp(min=1.0)
    return nll.sum() / denom, denom
