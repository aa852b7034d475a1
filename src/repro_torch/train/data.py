"""Deterministic synthetic data (the port's copy of the JAX package's
``repro/train/data.py``; numpy only, so both packages draw the same
batches bit for bit).

Token streams come from ``np.random.Generator`` keyed on
``SeedSequence([seed, step, shard])``, so any batch is reproducible from
(seed, step) alone (a checkpoint stores only the loader's cursor) and each
data shard draws from a disjoint key space.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..configs.base import ArchConfig


def make_batch(
    cfg: ArchConfig,
    batch_size: int,
    seq_len: int,
    step: int,
    seed: int = 0,
    shard: int = 0,
    n_shards: int = 1,
) -> Dict[str, np.ndarray]:
    """One global (or per-shard) batch for the given family."""
    if batch_size % n_shards:
        raise ValueError(f"batch of {batch_size} does not split into {n_shards} shards")
    b_local = batch_size // n_shards
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, shard])
    )
    V = cfg.vocab_size

    def tokens(b, s):
        return rng.integers(0, V, size=(b, s), dtype=np.int32)

    if cfg.family == "audio":
        frames = rng.normal(size=(b_local, seq_len, cfg.frontend_dim)).astype(
            np.float32
        )
        labels = tokens(b_local, seq_len)
        # mask ~8% of frames as prediction targets (HuBERT-style); others -1
        mask = rng.random((b_local, seq_len)) < 0.08
        labels = np.where(mask, labels, -1).astype(np.int32)
        return {"frames": frames, "labels": labels}

    if cfg.family == "vlm":
        Ti = cfg.vlm_img_tokens
        St = seq_len - Ti
        toks = tokens(b_local, St + 1)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
            "patch_embeds": rng.normal(
                size=(b_local, Ti, cfg.frontend_dim)
            ).astype(np.float32),
        }

    toks = tokens(b_local, seq_len + 1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}


class DataLoader:
    """Stateful cursor over the synthetic stream (checkpointable)."""

    def __init__(
        self,
        cfg: ArchConfig,
        batch_size: int,
        seq_len: int,
        seed: int = 0,
        start_step: int = 0,
    ):
        self.cfg = cfg
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed
        self.step = start_step

    def next(self) -> Dict[str, np.ndarray]:
        batch = make_batch(
            self.cfg, self.batch_size, self.seq_len, self.step, self.seed
        )
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])
