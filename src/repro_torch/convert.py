"""Convert parameters of the JAX package into the port's parameters, and
tensors to and from numpy with bfloat16 kept bit for bit.

``params_from_jax`` takes the JAX ``Model.init`` tree with every leaf
already converted to numpy (the caller does that step; this module
imports no JAX) and returns the same nested dicts of CPU torch tensors,
checked leaf by leaf against the shapes and dtypes of the port's
``Model.param_specs`` (an fp32 leaf, such as the MoE router, stays fp32
in a bf16 config).

numpy has no bfloat16 of its own.  The JAX package's arrays carry
ml_dtypes' ``bfloat16``; ``np.savez`` writes those as the raw two-byte
type ``|V2``, and ``np.load`` gives ``|V2`` back.  ``_to_tensor`` reads
either as bfloat16 bits, and ``to_numpy`` writes a bfloat16 tensor as
``|V2``, so the port needs no ml_dtypes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .configs.base import ArchConfig
from .models.model import Model


_BF16_BITS = np.dtype("V2")  # how np.savez stores a bfloat16 array


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor holding a copy of ``a``; ml_dtypes' bfloat16 and
    ``|V2`` become torch's bfloat16 with the same bits."""
    # Copy: a JAX-backed buffer is read-only and must not be aliased.
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16" or a.dtype == _BF16_BITS:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t``; bfloat16 comes out as its bits in ``|V2``, the
    dtype and bytes ``np.savez`` gives a JAX bfloat16 array."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_BITS)
    return t.numpy()


def params_from_jax(tree: Dict[str, Any], cfg: ArchConfig) -> Dict[str, Any]:
    """Port params from a JAX param tree of numpy arrays, for ``cfg``.

    Raises ``ValueError`` on a missing or extra key or a leaf whose shape
    or dtype differs from what the port builds for ``cfg``.
    """

    def walk(node: Any, spec: Any, path: str) -> Any:
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node).__name__
                raise ValueError(f"{path or 'params'}: keys {got}, expected {sorted(spec)}")
            return {k: walk(node[k], spec[k], f"{path}/{k}") for k in spec}
        t = _to_tensor(np.asarray(node))
        if t.shape != spec.shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)}, expected {tuple(spec.shape)}")
        if t.dtype != spec.dtype:
            raise ValueError(f"{path}: dtype {t.dtype}, expected {spec.dtype}")
        return t

    return walk(tree, Model(cfg, device="cpu").param_specs(), "")
