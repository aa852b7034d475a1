"""Plain PyTorch reference of a served mixture-of-experts model that follows
the program's recorded routing, in float32 with TF32 off.

A decode call of more rows than an expert has slots can drop pairs, and
which it drops depends on what every row of the call chose; in bfloat16 a
few routing choices also flip at near ties against float32, and a flip
changes everything after it.  So this reference takes the program's
expert choices for each (layer, token) it checks, and nothing else of
what the program computed:

* the router's probabilities are its own, and the weights of the pinned
  experts are its probabilities of them, renormalised over the K;
* each pair's slot, and so its drop, is re-derived from the whole call's
  choices by the capacity rule (``model.capacity`` of the call's rows; the
  pairs in row-major (token, choice) order, riding rows included);
* attention, norms and the rest are ``model.Reference``'s (attention in
  query blocks).

It imports nothing of the program.  The recorded routing comes as plain
data, one dict a model call in the order made: ``kind`` ("prefill" or
"decode"), ``rows`` (the request id of each row, None for a riding row),
and per layer ``top_i`` ``[T, K]`` (the experts chosen, most probable
first), ``slot`` ``[T*K]`` and ``keep`` ``[T*K]`` (the pair's slot, and
whether it got one).

The numbers it adds to ``serve_waves``' two:

* ``route_margin``: the widest relative distance, over every pinned
  choice of the checked tokens, by which the reference's probability of
  the program's expert falls below its own K-th largest (0 where each
  chosen expert is among the reference's top K);
* ``keep_mismatch``: the count of pairs, over every recorded call, whose
  recorded slot or drop differs from the re-derived one.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .model import Reference, _layers, capacity, fp32_strict

Call = Dict  # {"kind", "rows", "top_i": [L], "slot": [L], "keep": [L]}
Checked = Tuple[int, Sequence[int], Sequence[int]]  # (request id, prompt, served tokens)


def slots(cfg: dict, choices: torch.Tensor) -> torch.Tensor:
    """Each pair's slot ``[T*K]`` of a call whose tokens chose ``choices
    [T, K]``: the pairs before it, in row-major (token, choice) order, that
    chose the same expert; -1 where that is ``capacity`` of the call's rows
    or more (dropped)."""
    e = choices.reshape(-1)
    onehot = F.one_hot(e, cfg["num_experts"])
    before = (torch.cumsum(onehot, 0) - onehot).gather(1, e[:, None])[:, 0]
    return torch.where(before < capacity(cfg, choices.shape[0]), before, -1)


def keep_mismatch(cfg: dict, calls: Sequence[Call]) -> int:
    """Pairs of every call and layer whose recorded slot or drop differs
    from the one the capacity rule gives their call's choices."""
    wrong = [(torch.where(keep, slot, -1) != slots(cfg, top_i)).sum()
             for c in calls for top_i, slot, keep in zip(c["top_i"], c["slot"], c["keep"])]
    return int(torch.stack(wrong).sum()) if wrong else 0


def _rows_of(requests: Sequence[Checked], calls: Sequence[Call]) -> Dict[int, Tuple[List[int], List[int]]]:
    """For each call that holds a checked token: (its rows, the checked
    tokens' indices in the concatenation of the checked sequences).  A
    request's prompt is its one prefill call; its k-th served token but the
    last is fed by the k-th decode call that holds its id."""
    out: Dict[int, Tuple[List[int], List[int]]] = {}
    at = 0
    for rid, prompt, served in requests:
        pre = [i for i, c in enumerate(calls) if c["kind"] == "prefill" and list(c["rows"]) == [rid]]
        dec = [i for i, c in enumerate(calls) if c["kind"] == "decode" and rid in c["rows"]]
        if len(pre) != 1 or len(dec) != len(served) - 1 or calls[pre[0]]["top_i"][0].shape[0] != len(prompt):
            raise ValueError(f"request {rid}: {len(pre)} prefill calls and {len(dec)} decode calls recorded "
                             f"for a prompt of {len(prompt)} and {len(served)} served tokens")
        out[pre[0]] = (list(range(len(prompt))), list(range(at, at + len(prompt))))
        for k, i in enumerate(dec):
            rows, toks = out.setdefault(i, ([], []))
            rows.append(list(calls[i]["rows"]).index(rid))
            toks.append(at + len(prompt) + k)
        at += len(prompt) + len(served) - 1
    return out


class Pinned(Reference):
    """``Reference`` whose expert layer takes its choices from the recorded
    calls (``follow="program"``), or makes its own (``"own"``: the
    control's), and re-derives every pair's slot from its call's choices.
    ``swap_layer``: at that layer each checked token's K-th choice is
    replaced by the most probable expert not chosen (the ``route`` fault).
    After a forward, ``chosen[l]`` holds layer l's choices of the checked
    tokens and ``margin`` the widest ``route_margin`` met."""

    def __init__(self, cfg: dict, calls: Sequence[Call], rows: Dict, n_tokens: int, prec: str = "fp32",
                 follow: str = "program", swap_layer: Optional[int] = None):
        super().__init__(cfg, prec)
        if follow not in ("program", "own"):
            raise ValueError(f"follow {follow!r}")
        self.calls, self.follow, self.swap_layer = calls, follow, swap_layer
        dev = calls[0]["top_i"][0].device
        self.rows = {i: (torch.tensor(r, device=dev), torch.tensor(t, device=dev)) for i, (r, t) in rows.items()}
        self.n, self.layer = n_tokens, 0
        self.chosen: List[torch.Tensor] = []
        self.margin = torch.zeros((), device=dev)

    def moe(self, x, w, groups):
        K, l = self.cfg["num_experts_per_tok"], self.layer
        probs = torch.softmax(x @ w["router"], dim=-1)  # the router stays float32
        pinned = torch.empty(self.n, K, dtype=torch.int64, device=x.device)
        for i, (rows, toks) in self.rows.items():
            pinned[toks] = self.calls[i]["top_i"][l][rows]
        choice = torch.topk(probs, K, dim=-1).indices if self.follow == "own" else pinned
        if l == self.swap_layer:
            other = probs.scatter(1, choice, float("-inf")).argmax(-1)
            choice = torch.cat([choice[:, :-1], other[:, None]], dim=1)
        kth = torch.topk(probs, K, dim=-1).values[:, -1:]
        p = probs.gather(1, choice)
        self.margin = torch.maximum(self.margin, ((kth - p) / kth).max().clamp(min=0))
        keep = torch.empty(self.n, K, dtype=torch.bool, device=x.device)
        for i, (rows, toks) in self.rows.items():
            whole = self.calls[i]["top_i"][l].clone()
            whole[rows] = choice[toks]
            keep[toks] = (slots(self.cfg, whole).view(whole.shape) >= 0)[rows]
        self.chosen.append(choice)
        weight = torch.where(keep, p / p.sum(-1, keepdim=True), torch.zeros_like(p))
        out = torch.zeros_like(x)
        for e in range(self.cfg["num_experts"]):
            tok, col = torch.nonzero((choice == e) & keep, as_tuple=True)
            if tok.numel() == 0:
                continue
            xe = x[tok]
            ye = self.linear(F.silu(self.linear(xe, w["w_gate"][e])) * self.linear(xe, w["w_up"][e]),
                             w["w_down"][e])
            out = out.index_add(0, tok, ye * weight[tok, col][:, None])
        return out, torch.zeros((), device=x.device)


@torch.no_grad()
def served_logits(cfg: dict, tree: Dict, requests: Sequence[Checked], calls: Sequence[Call],
                  prec: str = "fp32", follow: str = "program",
                  swap_layer: Optional[int] = None) -> Tuple[List[torch.Tensor], Pinned]:
    """For each checked request ``(id, prompt, served tokens)``, the logits
    over the published vocabulary ``[n, V]`` from which each served token
    was chosen: one forward over the prompt and the served tokens but the
    last, teacher-forced, its expert layers as ``Pinned`` runs them.
    Layer by layer over all the requests, so that each layer is upcast
    once.  Returns the logits and the ``Pinned`` that ran (its ``chosen``
    and ``margin``)."""
    from ..weights import layer_slices

    fp32_strict()
    rows = _rows_of(requests, calls)
    dev = tree["final_norm"].device
    seqs = [torch.tensor(list(p) + list(g[:-1]), dtype=torch.long, device=dev) for _, p, g in requests]
    ref = Pinned(cfg, calls, rows, sum(s.numel() for s in seqs), prec, follow, swap_layer)
    pos = [torch.arange(s.numel(), device=dev) for s in seqs]
    h = [tree["embed"]["tokens"][s].float() for s in seqs]
    for layer, w in enumerate(_layers(dict(layer_slices(tree)), cfg["num_hidden_layers"])):
        ref.layer = layer
        h, _ = ref.block(h, {k: v.float() for k, v in w.items()}, pos, None)
    unembed = tree["embed"]["unembed"][:, :cfg["vocab_size"]].float()
    out = [ref.linear(ref.norm(x[len(p) - 1:], tree["final_norm"].float()), unembed)
           for x, (_, p, _) in zip(h, requests)]
    return out, ref


def with_choices(cfg: dict, requests: Sequence[Checked], calls: Sequence[Call],
                 chosen: Sequence[torch.Tensor]) -> List[Call]:
    """The calls as a program that chose ``chosen[l]`` for the checked
    tokens (a ``Pinned`` run's own choices) would have recorded them: the
    other rows' choices as they were, every slot by the capacity rule."""
    rows = _rows_of(requests, calls)
    out = [dict(c, top_i=list(c["top_i"]), slot=list(c["slot"]), keep=list(c["keep"])) for c in calls]
    for i, (r, t) in rows.items():
        for layer, choice in enumerate(chosen):
            whole = calls[i]["top_i"][layer].clone()
            whole[torch.tensor(r, device=whole.device)] = choice[torch.tensor(t, device=whole.device)]
            s = slots(cfg, whole)
            out[i]["top_i"][layer] = whole
            out[i]["slot"][layer] = torch.where(s >= 0, s, capacity(cfg, whole.shape[0]))
            out[i]["keep"][layer] = s >= 0
    return out
