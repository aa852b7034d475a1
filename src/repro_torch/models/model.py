"""Model facade of the port: init / loss / prefill / decode for all six
families (dense, moe, ssm, hybrid, vlm, audio).

The JAX package scans over stacked blocks (``repro/models/model.py``); the
port keeps the stacked ``[n_blocks, ...]`` parameter and cache leaves and
loops over the block index, and within a block over the sub-layers of
``cfg.layer_kinds()`` (mixer ``attn`` or ``mamba``, ff ``dense``, ``moe``
or ``none``; a hybrid block is a super-block of ``attn_period`` of them).
``loss`` recomputes every block in the backward pass
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` with
``nothing_saveable``).

The same code runs on DTensors: params placed by
``parallel.sharding.param_shardings`` and a batch by ``batch_shardings``
(``parallel.sharding.distribute``).  DTensor then picks each op's
placements from its inputs', and the model pins the residual stream
(``Model._constrain``) as the reference constrains it.

Batch dicts per family, as in the JAX package:
  dense/moe/ssm/hybrid : {"tokens": [B,S] i32, "labels": [B,S] i32}
  vlm   : {"tokens": [B,S_text], "labels": [B,S_text],
           "patch_embeds": [B,T_img,frontend_dim]}   (S_text+T_img = S)
  audio : {"frames": [B,S,frontend_dim], "labels": [B,S]}
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..parallel import opt_flags
from ..parallel import sharding as sh
from . import layers as L
from . import mamba as M
from . import moe as X

Params = Dict[str, Any]
Spec = Dict[str, Any]

def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` needs a CUDA device
    and raises without one: nothing carries on on the CPU unless the
    caller asked for it.  ``"meta"`` computes shapes only (the dry run)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"device must be cuda, cpu or meta, got {dev}")
    return dev


def _unbind(v: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``torch.unbind(v)`` over the leading (block) axis.  A DTensor is
    unbound on each rank's shard (``local_map``): DTensor's own unbind
    (and select) would first gather every shard of the stack."""
    if not isinstance(v, DTensor):
        return torch.unbind(v)
    if Shard(0) in v.placements or any(p.is_partial() for p in v.placements):
        raise ValueError(f"a stacked leaf split on its block axis: {v.placements}")
    out = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in v.placements]
    return local_map(
        torch.unbind, out_placements=tuple([out] * v.shape[0]),
        in_placements=(v.placements,), device_mesh=v.device_mesh,
    )(v)


def _unstack(tree: Params, n: int) -> List[Params]:
    """The ``n`` blocks of a stacked parameter tree, as views from one
    ``torch.unbind`` per leaf: in the backward pass each stacked leaf's
    gradient is then one stack of its blocks' gradients, not a sum of
    ``n`` zero-padded copies as separate ``v[i]`` views would give."""
    blocks: List[Params] = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else _unbind(v)
        for block, part in zip(blocks, parts):
            block[k] = part
    return blocks


def _apply_sub(
    sub: Params,
    cfg: ArchConfig,
    mixer: str,
    ff: str,
    h: torch.Tensor,
    q_pos: torch.Tensor,
    cache: Optional[Params],
    cache_index: L.CacheIndex,
    decode: bool,
    constrain=lambda h: h,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One sub-layer; returns (h, aux), aux the MoE load-balance term of
    an ``moe`` ff and None for the others.  ``constrain`` places the
    residual after each of the two adds."""
    y = L.rms_norm(h, sub["ln1"])
    if mixer == "attn":
        # prefill attends over its own k/v; decode over the cache
        y, _ = L.apply_attention(
            sub["attn"], cfg, y, q_pos,
            cache=cache, cache_index=cache_index, self_attend=not decode,
        )
    elif decode:
        y = M.apply_mamba_decode(sub["mamba"], cfg, y, cache)
    else:
        y = M.apply_mamba(sub["mamba"], cfg, y, cache)
    h = constrain(h + y)
    if ff == "none":
        return h, None
    y = L.rms_norm(h, sub["ln2"])
    if ff == "moe":
        y, aux = X.apply_moe(sub["moe"], cfg, y)
        return constrain(h + y), aux
    return constrain(h + L.apply_mlp(sub["mlp"], cfg, y)), None


def param_spec(cfg: ArchConfig) -> Spec:
    """Nested dict of ``(shape, init)`` per parameter leaf, in the JAX
    package's tree layout (see ``layers.init_from_spec`` for the init
    kinds).  Block leaves are stacked, with ``n_blocks`` in front."""
    nb = cfg.n_scan_blocks

    def stacked(spec: Spec) -> Spec:
        return {k: ((nb,) + shape, init) for k, (shape, init) in spec.items()}

    norm = ((nb, cfg.d_model), None)
    blocks: Spec = {}
    for i, (mixer, ff) in enumerate(cfg.layer_kinds()):
        sub: Spec = {"ln1": norm}
        if mixer == "attn":
            sub["attn"] = stacked(L.attention_spec(cfg))
        else:
            sub["mamba"] = stacked(M.mamba_spec(cfg))
        if ff == "dense":
            sub["ln2"] = norm
            sub["mlp"] = stacked(L.mlp_spec(cfg))
        elif ff == "moe":
            sub["ln2"] = norm
            sub["moe"] = stacked(X.moe_spec(cfg))
        blocks[f"sub{i}"] = sub
    spec: Spec = {
        "embed": L.embedding_spec(cfg),
        "blocks": blocks,
        "final_norm": ((cfg.d_model,), None),
    }
    F_, D = cfg.frontend_dim, cfg.d_model
    if cfg.family == "vlm":  # the 2-layer GeLU projector of patch embeddings
        spec["projector"] = {"w1": ((F_, D), F_**-0.5), "w2": ((D, D), D**-0.5)}
    elif cfg.family == "audio":  # the projection of frame features
        spec["frontend_proj"] = ((F_, D), F_**-0.5)
    return spec


class Model:
    def __init__(self, cfg: ArchConfig, device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.kinds = cfg.layer_kinds()
        self.n_blocks = cfg.n_scan_blocks
        # leaves ``loss`` never reads: an audio model embeds frames, so its
        # token table is read only when tied to the unembedding
        untied_audio = cfg.family == "audio" and not cfg.tie_embeddings
        self.unread_by_loss = frozenset({"embed/tokens"} if untied_audio else ())
        # Optional spec of the [B, S, D] residual stream at block boundaries
        # (Megatron-style sequence parallelism: S over the tensor-parallel
        # axis).  Set by launch/dryrun.py --opt sp.
        self.act_spec = None

    def _constrain(self, h: torch.Tensor, sub: bool = False) -> torch.Tensor:
        """The residual stream placed as the reference constrains it (a
        no-op on a plain tensor): ``act_spec`` when set, and after each
        sublayer ``(batch, "model", None)`` under ``sp_sub``.  Any other
        DTensor residual is pinned to the batch split, the sharding XLA
        keeps from the inputs; DTensor, which places op by op, would
        otherwise leave it split on D after the embedding lookup."""
        if not isinstance(h, DTensor):
            return h
        seq = h.ndim == 3 and h.shape[1] > 1
        if sub and seq and opt_flags.get("sp_sub"):
            spec = (opt_flags.get("batch_axes"), "model", None)
        elif seq and self.act_spec is not None:
            spec = self.act_spec
        else:
            spec = (sh.batch_axes(h.device_mesh, h.shape[0]),) + (None,) * (h.ndim - 1)
        return sh.constrain(h, spec)

    def init(self, generator: torch.Generator) -> Params:
        """Random params drawn from ``generator``, which must live on the
        model's device (weights are made where they will be used)."""
        if generator.device.type != self.device.type:
            raise ValueError(
                f"generator lives on {generator.device}, model on {self.device}"
            )
        return L.init_from_spec(generator, param_spec(self.cfg), L.dtype_of(self.cfg))

    def param_specs(self) -> Params:
        """The params' tree on the meta device: shapes and dtypes, no data
        (the JAX package's ``param_specs``, an ``eval_shape`` of init)."""
        return L.init_from_spec(
            torch.Generator(), param_spec(self.cfg), L.dtype_of(self.cfg), device="meta"
        )

    # ---- backbone -------------------------------------------------------

    def _block(
        self,
        block: Params,
        h: torch.Tensor,
        q_pos: torch.Tensor,
        block_cache: Optional[Params],
        cache_index: L.CacheIndex,
        decode: bool,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        aux_total = None
        block = sh.gather_fsdp(block)  # inside remat: gathered again for the backward
        for j, (mixer, ff) in enumerate(self.kinds):
            h, aux = _apply_sub(
                block[f"sub{j}"], self.cfg, mixer, ff, h, q_pos,
                block_cache[f"sub{j}"] if block_cache else None,
                cache_index, decode, lambda h: self._constrain(h, sub=True),
            )
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return h, aux_total

    def _backbone(
        self,
        params: Params,
        h: torch.Tensor,
        q_pos: torch.Tensor,
        cache: Optional[Params] = None,
        cache_index: L.CacheIndex = None,
        decode: bool = False,
        remat: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The blocks in order; returns (h, the blocks' summed MoE aux
        term, None without MoE layers).  ``remat``: each block's
        activations are recomputed in the backward pass instead of kept
        (training, no cache); its kernels then launch twice a step."""
        if remat and cache is not None:
            raise ValueError("remat recomputes blocks; it takes no cache")
        aux_total = None
        h = self._constrain(h)
        # views, so in-place cache writes land in the stacked tensors
        caches = _unstack(cache, self.n_blocks) if cache is not None else None
        for i, block in enumerate(_unstack(params["blocks"], self.n_blocks)):
            if remat:
                # no block draws random numbers: no RNG state to replay
                h, aux = checkpoint(
                    self._block, block, h, q_pos, None, None, False,
                    use_reentrant=False, preserve_rng_state=False,
                )
            else:
                block_cache = caches[i] if caches is not None else None
                h, aux = self._block(block, h, q_pos, block_cache, cache_index, decode)
            h = self._constrain(h)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return h, aux_total

    # ---- family-specific embedding --------------------------------------

    def _embed_inputs(
        self, params: Params, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, int]:
        """(h [B,S,D], n_prefix), n_prefix the rows before the text: audio
        projects its frames; vlm puts the projected patch embeddings (when
        the batch has them) before the text tokens; the other families
        embed their tokens."""
        dt = L.dtype_of(self.cfg)
        params = sh.gather_fsdp({k: v for k, v in params.items() if k != "blocks"})
        if self.cfg.family == "audio":
            frames = batch["frames"]
            B, S, F_ = frames.shape
            h = frames.to(dt).reshape(B * S, F_) @ params["frontend_proj"]
            return h.view(B, S, -1), 0
        tok = L.embed_tokens(params["embed"], batch["tokens"])
        if self.cfg.family == "vlm" and "patch_embeds" in batch:
            proj = params["projector"]
            img = batch["patch_embeds"].to(dt) @ proj["w1"]
            img = F.gelu(img, approximate="tanh") @ proj["w2"]  # jax.nn.gelu's default
            return torch.cat([img, tok], dim=1), img.shape[1]
        return tok, 0

    # ---- public API -----------------------------------------------------

    def loss(
        self, params: Params, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy against ``batch["labels"] [B,S]`` (-1
        ignored) of the family's inputs (see the module docstring; a vlm
        batch's image rows get no logits), every block recomputed in the
        backward pass.  Returns (loss, {"xent", "aux", "n_tokens"}), fp32
        scalars; ``aux`` (MoE's load-balance term summed over the blocks,
        weight 0.01) is 0 without MoE layers."""
        h, n_prefix = self._embed_inputs(params, batch)
        q_pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
        h, aux = self._backbone(params, h, q_pos, remat=True)
        h = L.rms_norm(h, params["final_norm"])
        if n_prefix:
            h = h[:, n_prefix:]
        logits = L.unembed(sh.gather_fsdp(params["embed"]), self.cfg, h)
        xent, n_tok = L.cross_entropy(logits, batch["labels"])
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=h.device)
        loss = xent + 0.01 * aux
        return loss, {"xent": xent, "aux": aux, "n_tokens": n_tok}

    def init_cache(
        self, batch: int, max_len: int, dtype: Optional[torch.dtype] = None
    ) -> Params:
        """Zeroed cache on the model's device, one entry per sub-layer:
        attention ``{"k","v": [n_blocks,B,W,G,K], "pos": [n_blocks,1,W]}``
        (``pos`` -1 marks unwritten slots), Mamba ``{"conv":
        [n_blocks,B,k-1,Ch], "ssm": [n_blocks,B,H,N,P] fp32}``."""
        dtype = dtype or L.dtype_of(self.cfg)
        out: Params = {}
        for j, (mixer, _) in enumerate(self.kinds):
            if mixer == "attn":
                one = L.init_attn_cache(self.cfg, batch, max_len, dtype, self.device)
            else:
                one = M.init_mamba_cache(self.cfg, batch, dtype, self.device)
            out[f"sub{j}"] = {
                k: v[None].repeat((self.n_blocks,) + (1,) * v.ndim)
                for k, v in one.items()
            }
        return out

    def prefill(
        self,
        params: Params,
        batch: Dict[str, torch.Tensor],
        cache: Optional[Params] = None,
    ) -> Tuple[torch.Tensor, Optional[Params]]:
        """Process the prompt (the family's inputs: tokens, image and text,
        or frames); returns (last-token logits [B,1,V], cache).  The cache
        is filled in place."""
        h, _ = self._embed_inputs(params, batch)
        S = h.shape[1]
        q_pos = torch.arange(S, dtype=torch.int32, device=h.device)
        h, _ = self._backbone(params, h, q_pos, cache=cache, cache_index=0)
        h = L.rms_norm(h, params["final_norm"])
        return L.unembed(sh.gather_fsdp(params["embed"]), self.cfg, h[:, -1:, :]), cache

    def decode_step(
        self,
        params: Params,
        cache: Params,
        tokens: torch.Tensor,  # [B,1]
        pos: Union[int, torch.Tensor],  # scalar (shared) or [B] (per-row)
    ) -> Tuple[torch.Tensor, Params]:
        """One decode step.  ``pos`` is the absolute position of this
        token: a scalar when the whole batch decodes in lockstep, or a
        per-row ``[B]`` vector when rows sit at different depths (the
        serving engine's continuous-refill loop).  The cache is updated in
        place and returned.  The new token is a text token in every
        family, embedded from the token table (as in the JAX package)."""
        h = L.embed_tokens(sh.gather_fsdp(params["embed"]), tokens)
        index = pos  # a Python int stays one: the cache slot needs no device value
        pos = torch.as_tensor(pos, dtype=torch.int32, device=h.device)
        q_pos = pos[None] if pos.ndim == 0 else pos[:, None]
        h, _ = self._backbone(params, h, q_pos, cache=cache, cache_index=index, decode=True)
        h = L.rms_norm(h, params["final_norm"])
        return L.unembed(sh.gather_fsdp(params["embed"]), self.cfg, h), cache


def n_params(params: Params) -> int:
    return sum(
        v.numel() if torch.is_tensor(v) else n_params(v) for v in params.values()
    )


def active_params(cfg: ArchConfig, params: Params) -> int:
    """Active (per-token) params: total minus inactive expert fraction."""
    total = n_params(params)
    if cfg.n_experts == 0:
        return total
    expert = 0
    blocks = params["blocks"]
    for i, (_mixer, ff) in enumerate(cfg.layer_kinds()):
        if ff == "moe":
            moe_p = blocks[f"sub{i}"]["moe"]
            expert += sum(moe_p[k].numel() for k in ("w_up", "w_gate", "w_down"))
    inactive = expert * (1.0 - cfg.top_k / cfg.n_experts)
    return int(total - inactive)
