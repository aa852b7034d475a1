"""The program under test, as the harness meets it: the port's configuration
built from the benchmark's configuration file, and the weights held to the
layout the port's model takes.  The only module of the harness, with the
traffic kinds, that imports the port."""
from __future__ import annotations

import dataclasses
from typing import Dict

from .weights import flat_leaves


# the port's ArchConfig field of each key of a configuration file
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model", "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim", "intermediate_size": "d_ff",
          "moe_intermediate_size": "d_ff", "vocab_size": "vocab_size", "num_experts": "n_experts",
          "num_experts_per_tok": "top_k", "rope_theta": "rope_theta", "torch_dtype": "dtype"}


def arch(cfg: dict):
    """The port's ``ArchConfig`` of a configuration file.  It has to be the
    port's registered architecture ``program_arch`` changed only in the keys
    the file lists as ``reduced``, and pad the vocabulary as the file says:
    a file that states another model than the one the port runs is
    refused."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig

    moe = bool(cfg.get("num_experts"))
    mine = ArchConfig(
        name=cfg["program_arch"], family="moe" if moe else "dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"],
        d_ff=cfg["moe_intermediate_size"] if moe else cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], qk_norm=bool(cfg.get("qk_norm")), rope_theta=cfg["rope_theta"],
        n_experts=cfg.get("num_experts", 0), top_k=cfg.get("num_experts_per_tok", 0),
        capacity_factor=cfg.get("capacity_factor", 1.25), dtype=cfg["torch_dtype"],
    )
    cut = {FIELDS[k]: getattr(mine, FIELDS[k]) for k in cfg["reduced"] if k in FIELDS}
    registered = dataclasses.replace(get_config(cfg["program_arch"]), **cut)
    differ = {f.name: (getattr(mine, f.name), getattr(registered, f.name)) for f in dataclasses.fields(mine)
              if f.name != "notes" and getattr(mine, f.name) != getattr(registered, f.name)}
    if differ or mine.padded_vocab != cfg["padded_vocab_size"]:
        raise ValueError(f"{cfg['name']}: the port's {cfg['program_arch']} differs: {differ}, "
                         f"padded vocabulary {mine.padded_vocab}")
    return mine


def check_layout(model, params: Dict) -> None:
    """The drawn weights have the tree, shapes and types the model takes."""
    want = {k: (tuple(v.shape), v.dtype) for k, v in flat_leaves(model.param_specs())}
    got = {k: (tuple(v.shape), v.dtype) for k, v in flat_leaves(params)}
    if want != got:
        raise ValueError(f"weights' layout differs from the model's: "
                         f"{sorted(set(want.items()) ^ set(got.items()))}")
