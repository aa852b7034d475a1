"""The weights of a cell, drawn from ``--seed`` on the device.

The benchmark makes the weights, hands them to the program, and hands the
same values to the reference, which upcasts them itself.  They are drawn in
two calls from a ``torch.Generator`` on the card, one ``torch.randn`` over
every weight of the configuration's type (``torch_dtype``) and one over the
float32 ones (norm scales, the router), and cut into leaves as views; each
leaf is then scaled to its init's spread.  So a seed gives the
same weights every time they are drawn, and a run can draw them again after
the program has trained its copy in place.

The tree is the layout the program takes (its ``Model.param_specs``, which
the harness holds it to), stated here from the configuration alone:
stacked ``[layers, ...]`` block leaves, ``blocks/sub0/{ln1, attn, ln2, mlp
or moe}``, ``embed/{tokens, unembed}`` over the padded vocabulary, and
``final_norm``.  Norm scales are drawn as ``1 + 0.1 N(0, 1)`` rather than
ones, so that a path that skips a scale shows.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import torch

ALIGN = 64  # elements: every leaf starts on a 128-byte boundary
SKETCH = 8  # random directions a slice is projected on

# (path, shape, dtype, kind, std): kind "normal" draws N(0, std^2), "scale" 1 + 0.1 N(0, 1)
Leaf = Tuple[str, Tuple[int, ...], torch.dtype, str, float]


def layout(cfg: dict) -> List[Leaf]:
    """Every weight of the configuration, in drawing order."""
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    H, G = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    K = cfg.get("head_dim") or D // H
    V = cfg["padded_vocab_size"]
    bf, f32 = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["torch_dtype"]], torch.float32
    out: List[Leaf] = [
        ("embed/tokens", (V, D), bf, "normal", 0.02),
        ("embed/unembed", (D, V), bf, "normal", D ** -0.5),
        ("blocks/sub0/ln1", (L, D), f32, "scale", 0.0),
        ("blocks/sub0/attn/wq", (L, D, H, K), bf, "normal", D ** -0.5),
        ("blocks/sub0/attn/wk", (L, D, G, K), bf, "normal", D ** -0.5),
        ("blocks/sub0/attn/wv", (L, D, G, K), bf, "normal", D ** -0.5),
        ("blocks/sub0/attn/wo", (L, H, K, D), bf, "normal", (H * K) ** -0.5),
        ("blocks/sub0/ln2", (L, D), f32, "scale", 0.0),
    ]
    if cfg.get("qk_norm"):
        out += [("blocks/sub0/attn/q_norm", (L, K), f32, "scale", 0.0),
                ("blocks/sub0/attn/k_norm", (L, K), f32, "scale", 0.0)]
    if cfg.get("num_experts"):
        E, F = cfg["num_experts"], cfg["moe_intermediate_size"]
        out += [
            ("blocks/sub0/moe/router", (L, D, E), f32, "normal", D ** -0.5),
            ("blocks/sub0/moe/w_up", (L, E, D, F), bf, "normal", D ** -0.5),
            ("blocks/sub0/moe/w_gate", (L, E, D, F), bf, "normal", D ** -0.5),
            ("blocks/sub0/moe/w_down", (L, E, F, D), bf, "normal", F ** -0.5),
        ]
    else:
        F = cfg["intermediate_size"]
        out += [
            ("blocks/sub0/mlp/w_up", (L, D, F), bf, "normal", D ** -0.5),
            ("blocks/sub0/mlp/w_gate", (L, D, F), bf, "normal", D ** -0.5),
            ("blocks/sub0/mlp/w_down", (L, F, D), bf, "normal", F ** -0.5),
        ]
    out.append(("final_norm", (D,), f32, "scale", 0.0))
    return out


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def draw(cfg: dict, seed: int, device) -> Dict:
    """The nested tree of weights for ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    leaves = layout(cfg)
    flat: Dict[str, torch.Tensor] = {}
    for dtype in dict.fromkeys(leaf[2] for leaf in leaves):  # the weights' type, then float32
        mine = [leaf for leaf in leaves if leaf[2] == dtype]
        offsets, total = [], 0
        for _, shape, _, _, _ in mine:
            offsets.append(total)
            total += -(-_numel(shape) // ALIGN) * ALIGN
        buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
        for (path, shape, _, kind, std), at in zip(mine, offsets):
            t = buf[at:at + _numel(shape)].view(shape)
            if kind == "scale":
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(std)
            flat[path] = t
    tree: Dict = {}
    for path, *_ in leaves:
        node = tree
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = flat[path]
    return tree


def flat_leaves(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every leaf of a nested dict, in sorted key order."""
    out: List[Tuple[str, torch.Tensor]] = []
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}/{k}" if prefix else k
        out += flat_leaves(v, path) if isinstance(v, dict) else [(path, v)]
    return out


def layer_slices(tree: Dict) -> List[Tuple[str, torch.Tensor]]:
    """Each weight of the model as the model defines it: a stacked block
    leaf ``[layers, ...]`` gives one slice a layer (``path[i]``), every
    other leaf is itself."""
    out: List[Tuple[str, torch.Tensor]] = []
    for path, t in flat_leaves(tree):
        if path.startswith("blocks/"):
            out += [(f"{path}[{i}]", t[i]) for i in range(t.shape[0])]
        else:
            out.append((path, t))
    return out


def sketch(name: str, x: torch.Tensor) -> torch.Tensor:
    """The projections of ``x`` on ``SKETCH`` random directions of its own
    shape, drawn from a seed made of ``name`` alone (so both sides of a
    comparison project a slice on the same directions).  For two tensors
    ``a`` and ``b`` of a slice, ``|sketch(a) - sketch(b)| / sqrt(SKETCH)``
    estimates ``|a - b|`` without holding both at once."""
    gen = torch.Generator(device=x.device).manual_seed(zlib.crc32(name.encode()))
    flat = x.detach().reshape(-1).float()
    return torch.stack([torch.dot(flat, torch.randn(flat.numel(), generator=gen, device=x.device))
                        for _ in range(SKETCH)]).double().cpu()
