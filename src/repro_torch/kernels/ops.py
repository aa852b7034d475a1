"""Wrappers of the port's kernels, with their gradients.

Each wrapper dispatches on the device of the tensor it is given: a CPU
tensor goes to the plain version in ``ref``, and autograd runs through
it; a CUDA tensor goes to the hand-written kernel in ``csrc/`` or the
call raises.  Nothing falls back from the kernel to the plain version.

On the card each wrapper is a ``torch.autograd.Function`` whose forward is
the kernel.  Flash attention's backward in bfloat16 is two kernels of its
own (``csrc/flash_attention_bwd.cu``, ``_flash_bwd_path``); every other
backward recomputes the plain version under ``torch.enable_grad()`` and
differentiates it (``_vjp``), as the JAX package's flash-attention
``custom_vjp`` does (``repro/kernels/ops.py``, ``_fa_bwd``): flash attention
in float32 and on the meta device, RMSNorm and the SSD scan always.

``LAUNCHES`` counts, per wrapper, the kernel launches it has made; it is
incremented right after a launch succeeds and nowhere else, so a run can
show that its main path went through the kernels (a block recomputed by
``torch.utils.checkpoint`` launches its kernels again, and counts them).
``FLASH_SHAPES`` splits the flash-attention launches by the kernel each
call ran (``_flash_route``), head dim and mask, e.g. ``"mma_prefill K=80
non-causal"`` or ``"decode K=120 causal window"``; ``FLASH_ROUTES`` is its
read-only sum by route.  ``RMSNORM_ROUTES`` and ``SSD_ROUTES`` split the
RMSNorm and SSD-scan launches by route (``_rmsnorm_route``,
``_ssd_route``).  ``DTENSOR_CALLS`` counts the calls that came as
DTensors (below), so that a run can show its launches all came that way.
``FLASH_BWD`` counts flash attention's backward calls by path
(``_flash_bwd_path``), head dim and mask, e.g. ``"kernel K=128 causal"`` or
``"plain K=16 causal"``; ``LAUNCHES`` and ``FLASH_SHAPES`` count forward
launches only.

Two more kinds of tensor reach the wrappers, and neither touches the path
of a plain CUDA tensor:

* **meta** tensors (the dry run, ``launch/dryrun.py``) take the card's
  path up to the launch: the same autograd Function, the same checks and
  outputs (and the SSD scan's workspace), then launch nothing and count
  nothing.  Each such call is reported to the callbacks in
  ``META_OBSERVERS`` with its tensors and its other arguments (mask,
  window, chunk, output type, eps): ``launch/cost.py`` prices it and keeps
  its shapes.
* **DTensors** run the wrapper on each rank's local shard through
  ``local_map``, with the placements the kernel allows: RMSNorm any that
  does not split the normalised axis; flash attention batch or heads
  (q's and k/v's alike), or q's sequence (``sp``), for which k and v are
  first gathered to the whole sequence; the SSD scan batch, heads or
  sequence (``sp``: each rank's rows scanned from the state the rows
  before them leave, ``_ssd_rows``).  Any other placement raises: nothing
  is replicated quietly, and nothing falls back to the plain version.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..dtensor_util import local_range, partial_where_split, unsplit, wrap_local
from . import _build, ref

LAUNCHES: Dict[str, int] = {"rmsnorm": 0, "flash_attention": 0, "ssd_scan": 0}
# calls through each wrapper's DTensor branch (local_map), whatever the device
DTENSOR_CALLS: Dict[str, int] = {"rmsnorm": 0, "flash_attention": 0, "ssd_scan": 0}
FLASH_SHAPES: Dict[str, int] = {}  # keys made by _flash_shape, added at first launch
FLASH_BWD: Dict[str, int] = {}  # backward calls, keys made by _flash_shape from the path
_FLASH_BWD_TILE = 64  # rows of a row tile in csrc/flash_attention_bwd.cu (kTile)
_FLASH_ROUTE_CODES = {"fma": 0, "decode": 1, "mma_prefill": 2}  # csrc/flash_attention.cu


class _FlashRoutes(Mapping):
    """Flash launches by route: ``FLASH_SHAPES`` summed over head dim and
    mask, one entry per route."""

    def __getitem__(self, route: str) -> int:
        if route not in _FLASH_ROUTE_CODES:
            raise KeyError(route)
        return sum(n for key, n in FLASH_SHAPES.items() if key.split()[0] == route)

    def __iter__(self) -> Iterator[str]:
        return iter(("decode", "mma_prefill", "fma"))

    def __len__(self) -> int:
        return len(_FLASH_ROUTE_CODES)

    def __repr__(self) -> str:
        return repr(dict(self))


FLASH_ROUTES = _FlashRoutes()
SSD_ROUTES: Dict[str, int] = {"mma": 0, "fma": 0}
RMSNORM_ROUTES: Dict[str, int] = {"row": 0, "general": 0}
_RMSNORM_ROUTE_CODES = {"general": 0, "row": 1}  # csrc/rmsnorm.cu
_RMSNORM_ROW_DIMS = (128, 1024, 2048, 4096)  # the widths of the row kernel
_SSD_ROUTE_CODES = {"fma": 0, "mma": 1}  # csrc/ssd_scan.cu

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the cases of csrc/flash_mma.cuh's with_head_dim, which
# tests/test_torch_families.py holds equal to this tuple
_HEAD_DIMS = (16, 64, 80, 120, 128)
_SSD_SIZES = (16, 32, 64, 128)  # the SSD kernel's P, N and chunk
_SSD_MMA_SIZES = (64, 128)  # N and chunk of the SSD scan's tensor-core route

# callbacks (name, inputs, outputs, other arguments) of every wrapper call
# on meta tensors
META_OBSERVERS: List[Callable[[str, Dict[str, torch.Tensor], Tuple[torch.Tensor, ...],
                               Dict[str, object]], None]] = []


def reset_launches() -> None:
    for counts in (LAUNCHES, DTENSOR_CALLS, SSD_ROUTES, RMSNORM_ROUTES):
        for name in counts:
            counts[name] = 0
    FLASH_SHAPES.clear()
    FLASH_BWD.clear()


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one
    CUDA device or all on the meta device; raises on a mix of devices or
    on another device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds in ({"cuda"}, {"meta"}) and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(
        f"tensors must all lie on the CPU, on one CUDA device or on the meta "
        f"device, got {sorted(str(t.device) for t in tensors)}"
    )


def _on_meta(name: str, inputs: Dict[str, Optional[torch.Tensor]], *outs: torch.Tensor,
             attrs: Dict[str, object]):
    """The end of a wrapper's card path on meta tensors: report the call
    (its tensors and ``attrs``, its other arguments) to ``META_OBSERVERS``
    and return the outputs unlaunched, uncounted."""
    given = {k: t for k, t in inputs.items() if t is not None}
    for observe in META_OBSERVERS:
        observe(name, given, outs, attrs)
    return outs[0] if len(outs) == 1 else outs


def _check_placements(name: str, t: DTensor, allowed: Sequence[object]) -> None:
    for p in t.placements:
        if p not in allowed:
            raise ValueError(
                f"{name}: placement {t.placements} not supported on the kernel "
                f"(each mesh dim one of {list(allowed)})"
            )


def _whole(name: str, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A plain tensor, or a replicated DTensor's local copy (positions)."""
    if isinstance(t, DTensor):
        _check_placements(name, t, (Replicate(),))
        return t.to_local()
    return t


def _grad_placements(inputs, out) -> Tuple:
    """``in_grad_placements`` for ``local_map``: an input whole on a mesh
    dim on which the output is split gets, from each rank, the gradient
    of that rank's part alone, a partial sum; elsewhere its gradient is
    placed as the input is."""
    return tuple(None if p is None else partial_where_split(p, out) for p in inputs)


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _dtype_code(dtype: torch.dtype, what: str) -> int:
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(
            f"{what}: dtype {dtype} not supported (float32 or bfloat16)"
        ) from None


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_aligned(name: str, **tensors: torch.Tensor) -> None:
    for what, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


def _vjp(
    plain: Callable[..., object],
    inputs: Sequence[Optional[torch.Tensor]],
    needs: Sequence[bool],
    grads_out: Sequence[Optional[torch.Tensor]],
) -> Tuple[Optional[torch.Tensor], ...]:
    """Gradients of ``plain(*inputs)`` (one output or a tuple) against
    ``grads_out``, for each input whose ``needs`` is True; None for the
    others, and for an output whose gradient is None.  The plain version
    is recomputed here on the inputs the forward saved (strided views
    stay strided), under ``enable_grad`` since backward runs without it."""
    with torch.enable_grad():
        live = [
            t.detach().requires_grad_(n) if t is not None else None
            for t, n in zip(inputs, needs)
        ]
        outs = plain(*live)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None]
        wrt = [t for t, n in zip(live, needs) if n]
        got = iter(
            torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs], allow_unused=True
            )
            if pairs and wrt
            else [None] * len(wrt)
        )
    return tuple(next(got) if n else None for n in needs)


class _RMSNorm(torch.autograd.Function):
    """Forward: the RMSNorm kernel.  Backward: ``ref.rmsnorm_ref``
    recomputed and differentiated."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rmsnorm_kernel(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        return _vjp(
            lambda x_, s_: ref.rmsnorm_ref(x_, s_, ctx.eps),
            (x, scale), ctx.needs_input_grad[:2], (g,),
        ) + (None,)


def rmsnorm(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis of x
    (any leading shape); fp32 statistics, output in x's dtype.  On the
    card: one kernel launch forward; the backward recomputes the plain
    version."""
    if isinstance(x, DTensor):
        return _rmsnorm_dtensor(x, scale, eps)
    if _on_cpu(x, scale):
        return ref.rmsnorm_ref(x, scale, eps)
    return _RMSNorm.apply(x, scale, eps)


def _rmsnorm_dtensor(x: DTensor, scale, eps: float) -> DTensor:
    """Each rank normalises its own rows: x sharded on any axis but the
    last, the scale replicated."""
    _check_placements("rmsnorm", x, [Replicate()] + [Shard(d) for d in range(x.ndim - 1)])
    DTENSOR_CALLS["rmsnorm"] += 1
    rep = (Replicate(),) * x.device_mesh.ndim
    inputs = (x.placements, rep if isinstance(scale, DTensor) else None)
    return local_map(
        lambda x_, s_: rmsnorm(x_, s_, eps),
        out_placements=list(x.placements),  # a list: one output
        in_placements=inputs,
        in_grad_placements=_grad_placements(inputs, x.placements),
        device_mesh=x.device_mesh,
    )(x, scale)


def _rmsnorm_kernel(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    D = x.shape[-1]
    if scale.shape != (D,) or scale.dtype != torch.float32:
        raise ValueError(
            f"rmsnorm: scale must be float32 [{D}], got {scale.dtype} "
            f"{tuple(scale.shape)}"
        )
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    code = _dtype_code(x.dtype, "rmsnorm")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    if x.is_meta:
        return _on_meta("rmsnorm", {"x": x, "scale": scale}, out, attrs={"eps": eps})
    route = _rmsnorm_route(D, x, scale, out)
    err = _build.load().rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, eps, code,
        _RMSNORM_ROUTE_CODES[route], _stream(x),
    )
    _check_launch("rmsnorm", err)
    RMSNORM_ROUTES[route] += 1
    return out


def _rmsnorm_route(D: int, *tensors: torch.Tensor) -> str:
    """The RMSNorm kernel a call on the card runs: ``row`` (a row held in
    registers, several rows a block) for D in ``_RMSNORM_ROW_DIMS`` with
    x, scale and y 16-byte aligned; ``general`` (a block a row) for any
    other call."""
    if D in _RMSNORM_ROW_DIMS and all(t.data_ptr() % 16 == 0 for t in tensors):
        return "row"
    return "general"


def _flash_route(Sq: int, dtype: torch.dtype) -> str:
    """The flash-attention kernel a call on the card runs: ``decode`` (CUDA
    cores, keys split among warps) for one query position in either type;
    ``mma_prefill`` (tensor cores) for several in bfloat16; ``fma`` (fp32
    FMA, which float32's tolerance needs) for several in float32."""
    if Sq == 1:
        return "decode"
    return "mma_prefill" if dtype == torch.bfloat16 else "fma"


def _flash_bwd_path(device: torch.device, dtype: torch.dtype) -> str:
    """The backward a flash-attention call takes: ``kernel`` (the two
    kernels of csrc/flash_attention_bwd.cu) for bfloat16 on the card;
    ``plain`` (``ref.flash_attention_ref`` recomputed in fp32 and
    differentiated) for float32, the ``fma`` route's type, whose tolerance
    bf16 products would not hold, and on the meta device, whose dry run
    prices the plain recompute."""
    return "kernel" if device.type == "cuda" and dtype == torch.bfloat16 else "plain"


def _flash_shape(route: str, K: int, causal: bool, window: Optional[int]) -> str:
    """The ``FLASH_SHAPES`` key of a launch (or the ``FLASH_BWD`` key of a
    backward, by path): route, head dim and mask."""
    mask = "causal" if causal else "non-causal"
    return f"{route} K={K} {mask}" + (" window" if window is not None else "")


def flash_attention(
    q: torch.Tensor,  # [B,Sq,H,K]
    k: torch.Tensor,  # [B,T,G,K]
    v: torch.Tensor,  # [B,T,G,K]
    q_pos: torch.Tensor,  # [Sq] shared, or [B,Sq] per-row, int32
    kv_pos: torch.Tensor,  # [T] int32; -1 = empty slot
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Online-softmax GQA attention.  Any Sq and T; the KV head of query
    head h is h // (H // G); masks come from the positions; output in q's
    dtype.  On the card: head_dim 16, 64, 80, 120 or 128, float32 or bfloat16, one
    launch of the kernel ``_flash_route`` names.  The backward is two
    kernel launches in bfloat16 and in float32 recomputes
    ``ref.flash_attention_ref`` (the gradient of the fp32 plain function,
    as in the JAX package): ``_flash_bwd_path``."""
    if isinstance(q, DTensor):
        return _flash_dtensor(q, k, v, q_pos, kv_pos, causal, window)
    if _on_cpu(q, k, v, q_pos, kv_pos):
        return ref.flash_attention_ref(q, k, v, q_pos, kv_pos, causal, window)
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, causal, window)


def _flash_dtensor(q: DTensor, k: DTensor, v: DTensor, q_pos, kv_pos, causal, window) -> DTensor:
    """Each rank attends with its own batch rows or query heads.  k and v
    are first gathered to the whole sequence on every mesh dim that splits
    it (a cache sharded on its slots).  Where q's heads are split and k/v's
    are whole (fewer KV heads than ranks), each rank slices out the KV
    heads its query heads read.  q may be split on its sequence (``sp``),
    each rank then taking its rows' positions."""
    if not (isinstance(k, DTensor) and isinstance(v, DTensor)):
        raise TypeError("flash_attention: q is a DTensor, so k and v must be")
    mesh = q.device_mesh
    k, v = unsplit(k, 1), unsplit(v, 1)
    _check_placements("flash_attention q", q, (Replicate(), Shard(0), Shard(1), Shard(2)))
    kv_heads_whole = Shard(2) not in k.placements
    for a, b in zip(q.placements, k.placements):
        a = Replicate() if a == Shard(1) or (a == Shard(2) and kv_heads_whole) else a
        if a != b or v.placements != k.placements:
            raise ValueError(
                f"flash_attention: q {q.placements} and k/v {k.placements}, "
                f"{v.placements} are not split alike on batch or heads"
            )
    H, G = q.shape[2], k.shape[2]
    h0, h1 = local_range(q, 2)
    rep = H // G  # query heads a KV head
    if kv_heads_whole and ((h1 - h0) % rep and rep % (h1 - h0)):
        raise ValueError(f"flash_attention: {h1 - h0} query heads a rank, {rep} a KV head")
    g0, g1 = h0 // rep, (h1 - 1) // rep + 1
    q_pos, kv_pos = _whole("flash_attention q_pos", q_pos), _whole("flash_attention kv_pos", kv_pos)
    s0, s1 = local_range(q, 1)
    q_pos = q_pos[..., s0:s1]
    if q_pos.ndim == 2:  # per-row positions follow the batch split
        b0, b1 = local_range(q, 0)
        q_pos = q_pos[b0:b1]

    DTENSOR_CALLS["flash_attention"] += 1

    def local(q_, k_, v_):
        if kv_heads_whole and (g0, g1) != (0, G):
            k_, v_ = k_[:, :, g0:g1].contiguous(), v_[:, :, g0:g1].contiguous()
        return flash_attention(q_, k_, v_, q_pos, kv_pos, causal, window)

    inputs = (q.placements, k.placements, v.placements)
    return local_map(
        local,
        out_placements=list(q.placements),
        in_placements=inputs,
        in_grad_placements=_grad_placements(inputs, q.placements),
        device_mesh=mesh,
    )(q, k, v)


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash-attention kernel.  Backward, by
    ``_flash_bwd_path``: the backward kernels, which also read the
    forward's output (saved by reference, for those calls alone); or the
    JAX package's ``_fa_bwd``, ``ref.flash_attention_ref`` recomputed and
    differentiated in q, k and v.  Each backward but a meta one is counted
    in ``FLASH_BWD``."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window):
        out = _flash_attention_kernel(q, k, v, q_pos, kv_pos, causal, window)
        ctx.path = _flash_bwd_path(q.device, q.dtype)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out if ctx.path == "kernel" else None)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_pos, kv_pos, out = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        if ctx.path == "kernel":
            grads = _flash_attention_bwd_kernel(q, k, v, out, g, q_pos, kv_pos, ctx.causal,
                                                ctx.window)
            grads = tuple(t if n else None for t, n in zip(grads, needs))
        else:
            grads = _vjp(
                lambda q_, k_, v_: ref.flash_attention_ref(
                    q_, k_, v_, q_pos, kv_pos, ctx.causal, ctx.window
                ),
                (q, k, v), needs, (g,),
            )
        if not q.is_meta:
            key = _flash_shape(ctx.path, q.shape[-1], ctx.causal, ctx.window)
            FLASH_BWD[key] = FLASH_BWD.get(key, 0) + 1
        return grads + (None,) * 4


def _flash_attention_kernel(q, k, v, q_pos, kv_pos, causal, window) -> torch.Tensor:
    B, Sq, H, K = q.shape
    T, G = k.shape[1], k.shape[2]
    if k.shape != (B, T, G, K) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: k/v must be [B,T,G,K]={B, T, G, K}-shaped, "
            f"got {tuple(k.shape)} and {tuple(v.shape)}"
        )
    if G == 0 or H % G:
        raise ValueError(f"flash_attention: H={H} not a multiple of G={G}")
    if K not in _HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head_dim {K} not supported on the card "
            f"(one of {_HEAD_DIMS})"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(
            f"flash_attention: q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
            f"{v.dtype}"
        )
    code = _dtype_code(q.dtype, "flash_attention")
    if q_pos.shape == (Sq,):
        q_pos_bstride = 0
    elif q_pos.shape == (B, Sq):
        q_pos_bstride = Sq
    else:
        raise ValueError(
            f"flash_attention: q_pos must be [Sq] or [B,Sq], got "
            f"{tuple(q_pos.shape)}"
        )
    if kv_pos.shape != (T,):
        raise ValueError(
            f"flash_attention: kv_pos must be [T]={T}, got "
            f"{tuple(kv_pos.shape)}"
        )
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError("flash_attention: q_pos and kv_pos must be int32")
    if not (q_pos.is_contiguous() and kv_pos.is_contiguous()):
        raise ValueError("flash_attention: q_pos and kv_pos must be contiguous")
    _require_aligned("flash_attention", q=q, k=k, v=v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if q.is_meta:
        return _on_meta("flash_attention", {"q": q, "k": k, "v": v, "q_pos": q_pos,
                                            "kv_pos": kv_pos}, out,
                        attrs={"causal": bool(causal), "window": window})
    route = _flash_route(Sq, q.dtype)
    err = _build.load().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        q_pos_bstride, kv_pos.data_ptr(), out.data_ptr(),
        B, Sq, T, H, G, K, int(causal), int(window is not None),
        int(window or 0), code, _FLASH_ROUTE_CODES[route], _stream(q),
    )
    _check_launch("flash_attention", err)
    shape = _flash_shape(route, K, causal, window)
    FLASH_SHAPES[shape] = FLASH_SHAPES.get(shape, 0) + 1
    return out


def _flash_attention_bwd_kernel(q, k, v, out, dout, q_pos, kv_pos, causal, window):
    """(dq, dk, dv) of one bfloat16 call on the card, from the two launches
    of csrc/flash_attention_bwd.cu; q, k, v and the positions passed the
    forward's checks.  Scratch: fp32 m, l and D of each row, and 16 bytes a
    row tile (``_FLASH_BWD_TILE`` rows of a (b, KV head))."""
    B, Sq, H, K = q.shape
    T, G = k.shape[1], k.shape[2]
    dout = dout.contiguous()
    _require_aligned("flash_attention backward", out=out, dout=dout)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:  # the forward launched nothing
        return dq, dk.zero_(), dv.zero_()
    rows = Sq * (H // G)
    stats = torch.empty(3 * B * G * rows, dtype=torch.float32, device=q.device)
    tiles = torch.empty(4 * B * G * -(-rows // _FLASH_BWD_TILE), dtype=torch.int32, device=q.device)
    err = _build.load().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        q_pos.data_ptr(), Sq if q_pos.ndim == 2 else 0, kv_pos.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), tiles.data_ptr(),
        B, Sq, T, H, G, K, int(causal), int(window is not None), int(window or 0), _stream(q),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention backward kernel launch failed: cudaError {err}")
    return dq, dk, dv


def _ssd_aligned(*tensors: torch.Tensor) -> bool:
    """True when each tensor's base is 16-byte aligned and its batch and
    sequence strides are multiples of 8 elements, as the SSD scan's
    tensor-core route copies rows in 16-byte pieces."""
    return all(
        t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 and t.stride(1) % 8 == 0
        for t in tensors
    )


def _ssd_route(dtype: torch.dtype, P: int, N: int, chunk: int, aligned: bool) -> str:
    """The SSD-scan kernel a call on the card runs: ``mma`` (tensor cores,
    chunks in parallel) for bfloat16 x, B and C with chunk and N each 64 or
    128, P a multiple of 32 and aligned rows (``_ssd_aligned``); ``fma``
    (fp32 FMA, chunks in sequence) for everything else, float32 included,
    whose tolerance the bf16 operands of the tensor cores would not hold
    without splitting every input too."""
    if (dtype == torch.bfloat16 and chunk in _SSD_MMA_SIZES and N in _SSD_MMA_SIZES
            and P % 32 == 0 and aligned):
        return "mma"
    return "fma"


def _ssd_workspace_bytes(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Scratch of the ``mma`` route (csrc/ssd_scan.cu, ``mma_header_bytes``):
    per block of 32 columns of P, two flags and a decay for every chunk
    but the last and a flag for every group of 8 chunks but the last, one
    ticket, all rounded up to 16 bytes; then the fp32 states [B, *, H, N, P]
    of every chunk but the last and of every group but the last."""
    nc = -(-S // chunk)
    ng = -(-nc // 8)
    blocks = B * H * (P // 32)
    header = -(-4 * (2 * (nc - 1) * blocks + (ng - 1) * blocks + 1) // 16) * 16
    return header + 4 * B * H * N * P * (nc - 1 + ng - 1)


def ssd_scan(
    x: torch.Tensor,  # [B,S,H,P]
    dt: torch.Tensor,  # [B,S,H] float32, softplus applied
    A: torch.Tensor,  # [H] float32, negative
    Bm: torch.Tensor,  # [B,S,N]
    Cm: torch.Tensor,  # [B,S,N]
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # [B,H,N,P] float32
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD chunked scan.  Returns (y [B,S,H,P] in
    ``out_dtype``, default x's dtype; final state [B,H,N,P] float32).

    x, B and C are float32 or bfloat16 (one type for the three) and may be
    strided over batch and sequence, as slices of one xBC tensor are; their
    last axis (and x's head axis) must be dense.  P, N and chunk are each
    one of 16, 32, 64, 128; S >= 1, and S need not be a chunk multiple.
    On a CPU tensor this runs ``ref.ssd_chunked_ref``, the chunked
    algorithm of the JAX model; on the card, one launch of the kernel
    ``_ssd_route`` names, and the backward recomputes the plain version."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    out_dtype = out_dtype or x.dtype
    if dt.shape != (Bsz, S, H) or A.shape != (H,):
        raise ValueError(
            f"ssd_scan: dt must be [B,S,H]={Bsz, S, H} and A [H]={H}, got "
            f"{tuple(dt.shape)} and {tuple(A.shape)}"
        )
    if Bm.shape != (Bsz, S, N) or Cm.shape != Bm.shape:
        raise ValueError(
            f"ssd_scan: B and C must be [B,S,N] with B,S={Bsz, S}, got "
            f"{tuple(Bm.shape)} and {tuple(Cm.shape)}"
        )
    if init_state is not None and (
        init_state.shape != (Bsz, H, N, P) or init_state.dtype != torch.float32
    ):
        raise ValueError(
            f"ssd_scan: init_state must be float32 [B,H,N,P]={Bsz, H, N, P}, "
            f"got {init_state.dtype} {tuple(init_state.shape)}"
        )
    if S < 1 or Bsz < 1:
        raise ValueError(f"ssd_scan: needs B >= 1 and S >= 1, got B={Bsz}, S={S}")
    for what, v in (("P", P), ("N", N), ("chunk", chunk)):
        if v not in _SSD_SIZES:
            raise ValueError(f"ssd_scan: {what}={v} not supported (one of {_SSD_SIZES})")
    if not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError(
            f"ssd_scan: x, B and C dtypes differ: {x.dtype}, {Bm.dtype}, {Cm.dtype}"
        )
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("ssd_scan: dt and A must be float32")
    _dtype_code(x.dtype, "ssd_scan")  # raises on a type the kernel does not take
    _dtype_code(out_dtype, "ssd_scan out_dtype")
    if isinstance(x, DTensor):
        return _ssd_dtensor(x, dt, A, Bm, Cm, chunk, init_state, out_dtype)
    tensors = (x, dt, A, Bm, Cm) + ((init_state,) if init_state is not None else ())
    if _on_cpu(*tensors):
        y, state = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk, init_state)
        return y.to(out_dtype), state
    return _SSDScan.apply(x, dt, A, Bm, Cm, init_state, chunk, out_dtype)


def _ssd_dtensor(x: DTensor, dt, A, Bm, Cm, chunk, init_state, out_dtype):
    """Each rank scans its own batch rows, heads or sequence rows.  On a
    mesh dim that splits heads, B and C stay whole and A is split like x's
    heads (a local slice of the replicated A: no transfer).  On one that
    splits the sequence (``sp``), dt, B and C are split alike, A and the
    initial state stay whole, and each rank starts from the state of the
    rows before its own (``_ssd_rows``); the final state is then whole on
    that mesh dim."""
    _check_placements("ssd_scan x", x, (Replicate(), Shard(0), Shard(1), Shard(2)))
    mesh, xp = x.device_mesh, x.placements
    pick = lambda batch, heads, seq=Replicate(): tuple(  # noqa: E731
        {Shard(0): batch, Shard(1): seq, Shard(2): heads}.get(p, Replicate()) for p in xp)
    want = {"dt": pick(Shard(0), Shard(2), Shard(1)), "A": pick(Replicate(), Shard(0)),
            "B": pick(Shard(0), Replicate(), Shard(1)), "C": pick(Shard(0), Replicate(), Shard(1)),
            "init_state": pick(Shard(0), Shard(1)), "y": xp}
    A = A.redistribute(mesh, want["A"]) if A.placements != want["A"] else A
    for what, t in (("dt", dt), ("B", Bm), ("C", Cm), ("init_state", init_state)):
        if t is not None and (not isinstance(t, DTensor) or t.placements != want[what]):
            raise ValueError(
                f"ssd_scan: x {xp} needs {what} placed {want[what]}, got "
                f"{getattr(t, 'placements', 'a plain tensor')}"
            )
    state_p = pick(Shard(0), Shard(1))
    DTENSOR_CALLS["ssd_scan"] += 1
    inputs = (xp, want["dt"], want["A"], want["B"], want["C"])
    if Shard(1) in xp:
        return _ssd_rows(x, dt, A, Bm, Cm, chunk, init_state, out_dtype, inputs, state_p)
    inputs += (state_p if init_state is not None else None,)
    return local_map(
        lambda x_, dt_, A_, B_, C_, s_: ssd_scan(x_, dt_, A_, B_, C_, chunk, s_, out_dtype),
        out_placements=(xp, state_p),
        in_placements=inputs,
        in_grad_placements=_grad_placements(inputs, xp),
        device_mesh=mesh,
    )(x, dt, A, Bm, Cm, init_state)


def _ssd_rows(x: DTensor, dt, A, Bm, Cm, chunk, init_state, out_dtype, inputs, state_p):
    """The scan of x split on its sequence over one mesh dim: each rank
    first takes the final state h_r of its own rows scanned from a zero
    state and their decay d_r = exp(A * sum(dt)) per (batch row, head)
    (``_RowsState``: one contraction over the rows); ``_CarryStates``
    gives each rank the state
    its rows start from, u_r (u_0 the initial state, u_{r+1} = d_r u_r +
    h_r); then one launch of the kernel scans the rows from u_r.  Returns
    (y placed as x, the whole sequence's final state u_m, alike on every
    rank of that mesh dim)."""
    mesh, xp = x.device_mesh, x.placements
    seq = [i for i, p in enumerate(xp) if p == Shard(1)]
    if len(seq) > 1:
        raise ValueError(f"ssd_scan: x {xp} splits the sequence over more than one mesh dim")
    # one entry a rank of the sequence split, stacked in front: [m, B, H(, N, P)]
    per_rank = tuple(Shard(0) if i == seq[0] else Shard(p.dim + 1) if p.is_shard() else p
                     for i, p in enumerate(state_p))
    grads = _grad_placements(inputs, xp)
    h, d = local_map(
        lambda x_, dt_, A_, B_: tuple(t[None] for t in _RowsState.apply(x_, dt_, A_, B_)),
        out_placements=(per_rank, per_rank), in_placements=inputs[:4],
        in_grad_placements=grads[:4], device_mesh=mesh,
    )(x, dt, A, Bm)
    start, end = _CarryStates.apply(h, d, init_state, seq[0], state_p)
    y = local_map(
        lambda x_, dt_, A_, B_, C_, s_: ssd_scan(x_, dt_, A_, B_, C_, chunk, s_[0], out_dtype)[0],
        out_placements=(xp,), in_placements=inputs + (per_rank,),
        in_grad_placements=grads + (per_rank,), device_mesh=mesh,
    )(x, dt, A, Bm, Cm, start)
    return y, end


def _weighted_rows(x, dt, A):
    """(wx, d) for rows x [B,S,H,P] from a zero state: each row's x
    weighted by its decay to the end of the rows and its dt, exp(a_S - a_t)
    dt_t x_t with a the running sum of dt A over the rows, and the rows'
    decay exp(a_S) [B,H]; fp32, elementwise."""
    a = torch.cumsum(dt * A, dim=1)
    last = a[:, -1]
    return x.float() * (torch.exp(last[:, None] - a) * dt)[..., None], torch.exp(last)


class _RowsState(torch.autograd.Function):
    """(h, d): the final state [B,H,N,P] of rows x [B,S,H,P] scanned from a
    zero state, sum_t B_t (x) wx_t (``_weighted_rows``), and the rows' decay.
    One contraction over the rows, two in the backward (h's gradient
    against B and against wx); the elementwise weights are recomputed
    there from the inputs, which the scan of the same rows saves anyway,
    so that no fp32 product of the rows is kept."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm)
        wx, d = _weighted_rows(x, dt, A)
        return torch.einsum("bsn,bshp->bhnp", Bm.float(), wx).contiguous(), d

    @staticmethod
    def backward(ctx, gh, gd):
        x, dt, A, Bm = ctx.saved_tensors
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            live = [t.detach().requires_grad_(n) for t, n in zip((x, dt, A), needs[:3])]
            wx, d = _weighted_rows(*live)
        gB = g_wx = None
        if gh is not None:
            g_wx = torch.einsum("bsn,bhnp->bshp", Bm.float(), gh)
            if needs[3]:
                gB = torch.einsum("bshp,bhnp->bsn", wx.detach(), gh).to(Bm.dtype)
        pairs = [(o, g) for o, g in ((wx, g_wx), (d, gd)) if g is not None]
        wrt = [t for t, n in zip(live, needs[:3]) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True) if pairs and wrt else [None] * len(wrt))
        return tuple(next(got) if n else None for n in needs[:3]) + (gB,)


class _CarryStates(torch.autograd.Function):
    """The states the ranks of a sequence split start from.  Inputs: each
    rank's own final state h [m, B, H, N, P] and decay d [m, B, H], stacked
    over the m ranks of mesh dim ``dim``, and the initial state (None:
    zeros).  Outputs: u_r stacked as h, and u_m placed ``state_p``, which
    every rank of ``dim`` computes alike.  The forward gathers the m
    states, [B, H, N, P] fp32 a rank, and frees them on return; only the
    decays and the rank's own u_r are saved.  The backward gathers the
    gradients of the u_r and runs the adjoint recursion from u_m's,
    l_m = g_m, l_r = g_r + d_r l_{r+1}: h_r's gradient is l_{r+1}, d_r's
    the sum of l_{r+1} u_r over (N, P), the initial state's l_0."""

    @staticmethod
    def forward(ctx, h, d, init, dim, state_p):
        ctx.set_materialize_grads(False)
        mesh = h.device_mesh
        r = mesh.get_coordinate()[dim]
        hs, ds = unsplit(h, 0).to_local(), unsplit(d, 0).to_local()
        u = init.to_local().clone() if init is not None else torch.zeros_like(hs[0])
        for t in range(hs.shape[0]):
            if t == r:
                mine = u
            u = ds[t][..., None, None] * u + hs[t]
        ctx.save_for_backward(ds, mine)
        ctx.mesh, ctx.r = mesh, r
        ctx.placed = ((h.placements, h.shape), (d.placements, d.shape), (state_p, h.shape[1:]))
        return (wrap_local(mine[None], mesh, h.placements, h.shape),
                wrap_local(u, mesh, state_p, h.shape[1:]))

    @staticmethod
    def backward(ctx, g_start, g_end):
        ds, mine = ctx.saved_tensors
        mesh, (hp, dp, sp) = ctx.mesh, ctx.placed
        lam = g_end.redistribute(mesh, sp[0]).to_local() if g_end is not None else torch.zeros_like(mine)
        gs = unsplit(g_start.redistribute(mesh, hp[0]), 0).to_local() if g_start is not None else None

        def back(t, lam):  # l_t from l_{t+1}
            return ds[t][..., None, None] * lam + (gs[t] if gs is not None else 0)

        for t in range(ds.shape[0] - 1, ctx.r, -1):
            lam = back(t, lam)
        g_h = wrap_local(lam[None], mesh, *hp)
        g_d = wrap_local((lam * mine).sum((-2, -1))[None], mesh, *dp)
        g_init = None
        if ctx.needs_input_grad[2]:
            for t in range(ctx.r, -1, -1):
                lam = back(t, lam)
            g_init = wrap_local(lam, mesh, *sp)
        return g_h, g_d, g_init, None, None


class _SSDScan(torch.autograd.Function):
    """Forward: the SSD-scan kernel.  Backward: ``ref.ssd_chunked_ref``
    (the JAX model's ``ssd_chunked``, which the JAX package differentiates)
    recomputed on the saved inputs, x, B and C as the strided views they
    came as, and differentiated; the final state may get no gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, init_state, chunk, out_dtype):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, init_state)
        ctx.chunk, ctx.out_dtype = chunk, out_dtype
        return _ssd_scan_kernel(x, dt, A, Bm, Cm, chunk, init_state, out_dtype)

    @staticmethod
    def backward(ctx, gy, gstate):
        def plain(x, dt, A, Bm, Cm, init_state):
            y, state = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, ctx.chunk, init_state)
            return y.to(ctx.out_dtype), state

        return _vjp(
            plain, ctx.saved_tensors, ctx.needs_input_grad[:6], (gy, gstate)
        ) + (None, None)


def _ssd_scan_kernel(x, dt, A, Bm, Cm, chunk, init_state, out_dtype):
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if x.stride(3) != 1 or x.stride(2) != P or Bm.stride(2) != 1 or Cm.stride(2) != 1:
        raise ValueError(
            "ssd_scan: x must be dense over [H,P] and B, C over N "
            f"(strides {x.stride()}, {Bm.stride()}, {Cm.stride()})"
        )
    if not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("ssd_scan: dt and A must be contiguous")
    if init_state is not None and not init_state.is_contiguous():
        raise ValueError("ssd_scan: init_state must be contiguous")
    route = _ssd_route(x.dtype, P, N, chunk, _ssd_aligned(x, Bm, Cm))
    y = torch.empty((Bsz, S, H, P), dtype=out_dtype, device=x.device)
    state = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ws = None
    if route == "mma":
        ws = torch.empty(_ssd_workspace_bytes(Bsz, S, H, P, N, chunk),
                         dtype=torch.uint8, device=x.device)
    if x.is_meta:
        return _on_meta("ssd_scan", {"x": x, "dt": dt, "A": A, "B": Bm, "C": Cm,
                                     "init_state": init_state}, y, state,
                        attrs={"chunk": chunk, "out_dtype": str(out_dtype).split(".")[-1]})
    err = _build.load().ssd_scan_fwd(
        x.data_ptr(), x.stride(0), x.stride(1), dt.data_ptr(), A.data_ptr(),
        Bm.data_ptr(), Bm.stride(0), Bm.stride(1),
        Cm.data_ptr(), Cm.stride(0), Cm.stride(1),
        init_state.data_ptr() if init_state is not None else None,
        y.data_ptr(), state.data_ptr(), Bsz, S, H, P, N, chunk,
        _dtype_code(x.dtype, "ssd_scan"), _dtype_code(out_dtype, "ssd_scan out_dtype"),
        _SSD_ROUTE_CODES[route], ws.data_ptr() if ws is not None else None,
        _stream(x),
    )
    _check_launch("ssd_scan", err)
    SSD_ROUTES[route] += 1
    return y, state
