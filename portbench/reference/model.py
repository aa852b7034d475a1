"""Plain PyTorch reference of the benchmark's decoder models, in float32
with TF32 off.

It follows the published architectures (Llama-style blocks: RMSNorm,
rotary embedding over the two halves of a head, grouped-query causal
attention, SwiGLU MLP; Qwen3-MoE's per-head q/k RMSNorm and top-k router
with renormalised probabilities) and the configuration as it is run: a
mixture-of-experts call gives each expert ``capacity(tokens)`` slots and
drops the pairs past them in row-major (token, choice) order, and the loss
adds ``router_aux_loss_coef`` times each layer's Switch load-balancing term.
It takes its weights as the benchmark drew them (``weights.draw``) and
upcasts them itself, a layer at a time; it imports nothing of the program
and takes nothing the program made.

``prec="fp8"`` is the control: every matrix product's input rows and weight
columns rounded to float8 e4m3 with their own absmax scale (a W8A8 fp8
product, the step a later change might take on Hopper), the rest as above.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

QUERY_BLOCK = 1024  # attention in blocks of query rows, so that the scores fit
HEAD_ROWS = 2048  # the training loss's logits in blocks of rows


def fp32_strict() -> None:
    """Float32 products in float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one absmax scale along ``dim``; the gradient
    passes straight through."""
    s = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


def capacity(cfg: dict, tokens: int) -> int:
    """Slots per expert of a call over ``tokens`` tokens: the expected pairs
    an expert gets times the capacity factor, rounded half to even, then up
    to a multiple of 8, at least 8."""
    cap = int(round(tokens * cfg["num_experts_per_tok"] / cfg["num_experts"] * cfg["capacity_factor"]))
    return max(8, ((cap + 7) // 8) * 8)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, qpos: torch.Tensor,
            kpos: torch.Tensor) -> torch.Tensor:
    """Softmax attention of queries ``q [q, H, K]`` over keys at positions
    up to their own."""
    s = torch.einsum("qhk,thk->hqt", q, k) * q.shape[-1] ** -0.5
    s = s.masked_fill((kpos[None, :] > qpos[:, None])[None], float("-inf"))
    return torch.einsum("hqt,thk->qhk", torch.softmax(s, dim=-1), v)


class Reference:
    def __init__(self, cfg: dict, prec: str = "fp32"):
        if prec not in ("fp32", "fp8"):
            raise ValueError(f"precision {prec!r}")
        self.cfg, self.prec = cfg, prec
        self.D, self.H, self.G = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
        self.K = cfg.get("head_dim") or self.D // self.H
        self.eps = cfg["rms_norm_eps"]

    # ---- pieces ---------------------------------------------------------

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., Din] @ w [Din, Dout]."""
        if self.prec == "fp8":
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * scale

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x [S, heads, K] rotated by position: the first half of each head
        against the second."""
        half = self.K // 2
        inv = self.cfg["rope_theta"] ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
        ang = pos.float()[:, None, None] * inv
        cos, sin = torch.cos(ang), torch.sin(ang)
        a, b = x[..., :half], x[..., half:]
        return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)

    def attention(self, x: torch.Tensor, w: Dict[str, torch.Tensor], pos: torch.Tensor) -> torch.Tensor:
        """Causal self-attention of one sequence ``x [S, D]``."""
        S, D, H, G, K = x.shape[0], self.D, self.H, self.G, self.K
        q = self.linear(x, w["wq"].reshape(D, H * K)).view(S, H, K)
        k = self.linear(x, w["wk"].reshape(D, G * K)).view(S, G, K)
        v = self.linear(x, w["wv"].reshape(D, G * K)).view(S, G, K)
        if "q_norm" in w:
            q, k = self.norm(q, w["q_norm"]), self.norm(k, w["k_norm"])
        q, k = self.rope(q, pos), self.rope(k, pos)
        k = k.repeat_interleave(H // G, dim=1)
        v = v.repeat_interleave(H // G, dim=1)
        outs = []
        for a in range(0, S, QUERY_BLOCK):
            args = (q[a:a + QUERY_BLOCK], k, v, pos[a:a + QUERY_BLOCK], pos)
            # under autograd each block's scores are recomputed for its backward
            outs.append(torch.utils.checkpoint.checkpoint(_attend, *args, use_reentrant=False)
                        if torch.is_grad_enabled() else _attend(*args))
        o = torch.cat(outs).reshape(S, H * K)
        return self.linear(o, w["wo"].reshape(H * K, D))

    def mlp(self, x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.linear(F.silu(self.linear(x, w["w_gate"])) * self.linear(x, w["w_up"]), w["w_down"])

    def moe(self, x: torch.Tensor, w: Dict[str, torch.Tensor],
            groups: Sequence[Tuple[int, int, Optional[int]]]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k experts of ``x [T, D]``.  ``groups``: the routing calls,
        ``(first, end, slots)`` over consecutive rows, each giving every
        expert ``slots`` slots (None: as many as its pairs).  Returns (the
        output [T, D], the mean over the calls of the Switch load term)."""
        E, k = self.cfg["num_experts"], self.cfg["num_experts_per_tok"]
        T = x.shape[0]
        probs = torch.softmax(x @ w["router"], dim=-1)  # the router stays float32
        top_p, top_i = torch.topk(probs, k, dim=-1)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        keep = torch.ones(T, k, dtype=torch.bool, device=x.device)
        aux = []
        for a, b, slots in groups:
            onehot = F.one_hot(top_i[a:b].reshape(-1), E)  # [(b - a) k, E], row-major pairs
            load = onehot.sum(0)
            aux.append(E * torch.sum(load.float() / onehot.shape[0] * probs[a:b].mean(0)))
            if slots is not None:
                before = (torch.cumsum(onehot, 0) - onehot)[onehot.bool()]  # pairs ahead, same expert
                keep[a:b] = (before < slots).view(b - a, k)
        out = torch.zeros_like(x)
        weight = torch.where(keep, top_p, torch.zeros_like(top_p))
        for e in range(E):
            rows, col = torch.nonzero((top_i == e) & keep, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            ye = self.linear(F.silu(self.linear(xe, w["w_gate"][e])) * self.linear(xe, w["w_up"][e]),
                             w["w_down"][e])
            out = out.index_add(0, rows, ye * weight[rows, col][:, None])
        return out, torch.stack(aux).mean()

    def block(self, h: List[torch.Tensor], w: Dict[str, torch.Tensor], pos: List[torch.Tensor],
              groups) -> Tuple[List[torch.Tensor], Optional[torch.Tensor]]:
        """One layer over sequences ``h`` (each [S_i, D], positions
        ``pos``); the feed-forward sees their rows together."""
        h = [x + self.attention(self.norm(x, w["ln1"]), w, p) for x, p in zip(h, pos)]
        rows = torch.cat(h)
        y = self.norm(rows, w["ln2"])
        if "router" in w:
            y, aux = self.moe(y, w, groups)
        else:
            y, aux = self.mlp(y, w), None
        out = rows + y
        return list(out.split([x.shape[0] for x in h])), aux


# --------------------------------------------------------------------------
# serving: logits of served tokens, teacher-forced
# --------------------------------------------------------------------------


@torch.no_grad()
def served_logits(cfg: dict, tree: Dict, requests: Sequence[Tuple[Sequence[int], Sequence[int]]],
                  prec: str = "fp32", batch_rows: int = 8) -> List[torch.Tensor]:
    """For each request ``(prompt, served tokens)``, the logits over the
    published vocabulary ``[n, V]`` from which each served token was chosen:
    one forward over the prompt and the served tokens but the last.  Its
    feed-forward routes the prompt as one call (``capacity`` of its length)
    and drops no pair of a later token, as serving with a decode batch of at
    most ``batch_rows`` rows does (no expert can get more pairs than it has
    slots there).  Layer by layer over all the requests, so that each layer is
    upcast once."""
    from ..weights import layer_slices

    fp32_strict()
    ref = Reference(cfg, prec)
    dev = tree["final_norm"].device
    seqs = [torch.tensor(list(p) + list(g[:-1]), dtype=torch.long, device=dev) for p, g in requests]
    pos = [torch.arange(s.numel(), device=dev) for s in seqs]
    h = [tree["embed"]["tokens"][s].float() for s in seqs]
    groups, at = [], 0
    if cfg.get("num_experts") and capacity(cfg, batch_rows) < batch_rows:
        raise ValueError(f"a decode call of {batch_rows} rows can drop pairs, which the reference does not follow")
    for (p, g), s in zip(requests, seqs):
        groups.append((at, at + len(p), capacity(cfg, len(p)) if cfg.get("num_experts") else None))
        if s.numel() > len(p):
            groups.append((at + len(p), at + s.numel(), None))
        at += s.numel()
    for w in _layers(dict(layer_slices(tree)), cfg["num_hidden_layers"]):
        h, _ = ref.block(h, {k: v.float() for k, v in w.items()}, pos, groups)
    V = cfg["vocab_size"]
    unembed = tree["embed"]["unembed"][:, :V].float()
    out = []
    for x, (p, g) in zip(h, requests):
        rows = ref.norm(x[len(p) - 1:], tree["final_norm"].float())
        out.append(ref.linear(rows, unembed))
    return out


# --------------------------------------------------------------------------
# training: three steps of AdamW from the same weights and batches
# --------------------------------------------------------------------------


def cosine_lr(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr_peak``, then a cosine to 0 at ``total_steps``."""
    if step < opt["warmup_steps"]:
        return opt["lr_peak"] * step / max(opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return 0.5 * opt["lr_peak"] * (1.0 + math.cos(math.pi * prog))


def _layers(params: Dict[str, torch.Tensor], n: int) -> List[Dict[str, torch.Tensor]]:
    """Each layer's weights by their short names, from slices named as
    ``weights.layer_slices`` names them (``blocks/sub0/attn/wq[3]``)."""
    out: List[Dict[str, torch.Tensor]] = [{} for _ in range(n)]
    for k, t in params.items():
        if k.startswith("blocks/"):
            path, i = k[:-1].split("[")
            out[int(i)][path.rsplit("/", 1)[1]] = t
    return out


def loss_of(ref: Reference, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over every row of ``tokens [B, S]``,
    over the padded vocabulary the model is run with, plus the router's
    load term; every layer recomputed in the backward pass."""
    cfg = ref.cfg
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)
    h = list(params["embed/tokens"][tokens])
    groups = [(0, B * S, capacity(cfg, B * S))] if cfg.get("num_experts") else None
    aux = torch.zeros((), device=tokens.device)
    for w in _layers(params, cfg["num_hidden_layers"]):

        def run(*hs, w=w):
            out, a = ref.block(list(hs), w, [pos] * B, groups)
            return (*out, a if a is not None else torch.zeros((), device=tokens.device))

        *h, a = torch.utils.checkpoint.checkpoint(run, *h, use_reentrant=False)
        aux = aux + a
    x = torch.stack(h).reshape(B * S, -1)
    labels = labels.reshape(-1)

    def nll(xs, ls):
        logits = ref.linear(ref.norm(xs, params["final_norm"]), params["embed/unembed"])
        return F.cross_entropy(logits, ls, reduction="sum")

    # the logits a block of rows at a time, each block's recomputed for its gradient
    xent = sum(torch.utils.checkpoint.checkpoint(nll, x[a:a + HEAD_ROWS], labels[a:a + HEAD_ROWS],
                                                 use_reentrant=False)
               for a in range(0, B * S, HEAD_ROWS)) / (B * S)
    return xent + cfg.get("router_aux_loss_coef", 0.0) * aux


def train_three(cfg: dict, draw: Callable[[], Dict], batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                opt: dict, prec: str = "fp32", rows: Optional[int] = None) -> dict:
    """AdamW over ``batches`` (one a step) from the weights ``draw()``
    gives, in float32, each layer slice (``weights.layer_slices``) a leaf of
    its own.  Returns each step's loss, the first gradient's global norm
    before clipping, the norm and the sketch (``weights.sketch``) of each
    slice's first gradient as the optimizer takes it (clipped), and the norm of each slice's change after the last
    step.  ``rows``: only the first rows of each
    batch (the fault of a step that drops part of its batch)."""
    from ..weights import layer_slices, sketch

    fp32_strict()
    ref = Reference(cfg, prec)
    slices = layer_slices(draw())
    start = {k: t.to("cpu", copy=True) for k, t in slices}  # for the change, off the card
    params = {k: t.to(torch.float32, copy=True).requires_grad_() for k, t in slices}
    del slices
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first = [], None
    for step, (tokens, labels) in enumerate(batches, start=1):
        if rows is not None:
            tokens, labels = tokens[:rows], labels[:rows]
        with torch.enable_grad():
            loss = loss_of(ref, params, tokens, labels)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(opt["clip_norm"] / (gnorm + 1e-9), max=1.0)
            if step == 1:
                first_norm = float(gnorm)
                first = {k: float(torch.linalg.vector_norm(g)) * float(scale) for k, g in grads.items()}
                first_sketch = {k: sketch(k, g * scale) for k, g in grads.items()}
            lr = cosine_lr(opt, step)
            b1c, b2c = 1.0 - opt["b1"] ** step, 1.0 - opt["b2"] ** step
            for k, p in params.items():
                g = grads.pop(k) * scale
                m[k].mul_(opt["b1"]).add_((1.0 - opt["b1"]) * g)
                v2[k].mul_(opt["b2"]).add_((1.0 - opt["b2"]) * g * g)
                delta = (m[k] / b1c) / (torch.sqrt(v2[k] / b2c) + opt["eps"])
                if k != "final_norm":  # decay: every weight but the final norm's scale
                    delta = delta + opt["weight_decay"] * p
                p.sub_(lr * delta)
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(p - start[k].to(p.device).float()))
                  for k, p in params.items()}
    return {"loss": losses, "first_norm": first_norm, "first_grad": first, "first_sketch": first_sketch,
            "change": change}
