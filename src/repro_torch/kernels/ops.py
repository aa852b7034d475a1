"""Wrappers of the port's kernels, forward only.

Each wrapper dispatches on the device of the tensor it is given: a CPU
tensor goes to the plain version in ``ref``; a CUDA tensor goes to the
hand-written kernel in ``csrc/`` or the call raises.  Nothing falls back
from the kernel to the plain version.

``LAUNCHES`` counts, per wrapper, the kernel launches it has made; it is
incremented right after a launch succeeds and nowhere else, so a run can
show that its main path went through the kernels.

The JAX package's ``custom_vjp`` backward of flash attention
(``repro/kernels/ops.py``) waits for the training slice.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import _build, ref

LAUNCHES: Dict[str, int] = {"rmsnorm": 0, "flash_attention": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises on a mix of devices
    or on a device other than CPU and CUDA."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(
        f"tensors must all lie on the CPU or on one CUDA device, got "
        f"{sorted(str(t.device) for t in tensors)}"
    )


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _dtype_code(t: torch.Tensor, what: str) -> int:
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"{what}: dtype {t.dtype} not supported (float32 or bfloat16)"
        ) from None


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_aligned(name: str, **tensors: torch.Tensor) -> None:
    for what, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


def rmsnorm(
    x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis of x
    (any leading shape); fp32 statistics, output in x's dtype."""
    if _on_cpu(x, scale):
        return ref.rmsnorm_ref(x, scale, eps)
    D = x.shape[-1]
    if scale.shape != (D,) or scale.dtype != torch.float32:
        raise ValueError(
            f"rmsnorm: scale must be float32 [{D}], got {scale.dtype} "
            f"{tuple(scale.shape)}"
        )
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    code = _dtype_code(x, "rmsnorm")
    out = torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows == 0:
        return out
    err = _build.load().rmsnorm_fwd(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, D, eps, code,
        _stream(x),
    )
    _check_launch("rmsnorm", err)
    return out


def flash_attention(
    q: torch.Tensor,  # [B,Sq,H,K]
    k: torch.Tensor,  # [B,T,G,K]
    v: torch.Tensor,  # [B,T,G,K]
    q_pos: torch.Tensor,  # [Sq] shared, or [B,Sq] per-row, int32
    kv_pos: torch.Tensor,  # [T] int32; -1 = empty slot
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Online-softmax GQA attention, forward.  Any Sq and T; the KV head of
    query head h is h // (H // G); masks come from the positions; output
    in q's dtype.  On the card: head_dim 64 or 128, float32 or bfloat16."""
    if _on_cpu(q, k, v, q_pos, kv_pos):
        return ref.flash_attention_ref(q, k, v, q_pos, kv_pos, causal, window)
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
    code = _dtype_code(q, "flash_attention")
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
    err = _build.load().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        q_pos_bstride, kv_pos.data_ptr(), out.data_ptr(),
        B, Sq, T, H, G, K, int(causal), int(window is not None),
        int(window or 0), code, _stream(q),
    )
    _check_launch("flash_attention", err)
    return out
