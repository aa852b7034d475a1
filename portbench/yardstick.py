"""The benchmark's yardstick: the H100's published peaks, the least time of
a kernel call from its shapes, the model FLOPs behind the MFU metrics, and
the reduction of a profiler trace to device busy time and idle gaps.

It lives with the benchmark so that every later change of the program is
measured by the same rule, and it imports nothing of the program.  The
arithmetic is that of the port's bring-up smoke run (``chip_smoke.py::bound``,
``rmsnorm_bound``, ``flash_bound`` and the peaks of
``repro_torch/launch/analysis.py``): each input is read once and each output
written once, whatever a kernel reads again.

Configurations are the dicts of ``portbench/configs/*.json`` (Hugging Face
key names).
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# NVIDIA's H100 SXM data sheet: dense rates at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def least_ms(bytes_moved: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time a call can take: the larger of its bytes over the
    memory bandwidth and its operations over the peak rate."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / peak_flops) * 1e3


def rmsnorm_least_ms(rows: int, width: int, esize: int = 2) -> float:
    """One RMSNorm call over ``rows`` rows of ``width``: x read and y written
    once, the fp32 scale read once, 4 operations an element (fp32)."""
    return least_ms(rows * width * 2 * esize + 4 * width, 4 * rows * width, PEAK_FP32_FLOPS)


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal self-attention over S positions sees."""
    return S * (S + 1) // 2


def flash_causal_least_ms(B: int, S: int, H: int, G: int, K: int, esize: int = 2) -> float:
    """One causal self-attention call, ``B`` sequences of ``S`` positions
    (the prefill and the train step): q read and the output written once,
    every key and value row read once, the int32 positions read once; 4 K
    operations a visible (query, key) pair and head."""
    moved = 2 * B * S * H * K * esize + 2 * B * S * G * K * esize + 4 * 2 * S
    return least_ms(moved, 4 * K * H * B * causal_pairs(S))


# --------------------------------------------------------------------------
# model FLOPs
# --------------------------------------------------------------------------


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def layer_matmul_params(cfg: dict) -> int:
    """Weights of one layer that a token multiplies by, counted as the model
    defines it: the attention projections, then the dense MLP or, for a
    mixture of experts, the router and the ``num_experts_per_tok`` experts a
    token is routed to."""
    D, H, G, K = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    attn = D * H * K + 2 * D * G * K + H * K * D
    if cfg.get("num_experts"):
        ff = D * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * D * cfg["moe_intermediate_size"]
    else:
        ff = 3 * D * cfg["intermediate_size"]
    return attn + ff


def attention_pair_flops(cfg: dict) -> int:
    """Forward operations of one layer's attention for one (query, key)
    pair: QK^T and PV, 2 each a multiply-add, over every query head."""
    return 4 * cfg["num_attention_heads"] * head_dim(cfg)


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x (the layers' matmul weights a
    token meets + the LM head over the published vocabulary) x tokens, plus
    causal attention, its forward counted once and its backward twice.  The
    recompute of rematerialised blocks is not counted."""
    L = cfg["num_hidden_layers"]
    dense = L * layer_matmul_params(cfg) + cfg["hidden_size"] * cfg["vocab_size"]
    attn = L * attention_pair_flops(cfg) * batch * causal_pairs(seq)
    return 6.0 * dense * batch * seq + 3.0 * attn


def serve_request_flops(cfg: dict, prompt: int, generated: int) -> float:
    """Model FLOPs of one served request of ``prompt`` tokens and
    ``generated`` greedy tokens: the prompt and every generated token but the
    last go through the layers, the LM head gives one row of logits a
    generated token, and each token attends over the keys before it and
    its own."""
    L = cfg["num_hidden_layers"]
    fed = prompt + generated - 1
    pairs = causal_pairs(prompt) + sum(prompt + i for i in range(1, generated))
    return (2.0 * L * layer_matmul_params(cfg) * fed
            + 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * generated
            + L * attention_pair_flops(cfg) * pairs)


# --------------------------------------------------------------------------
# the profiler's trace
# --------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # a kernel's name in the breakdown, cut to this many characters


class Trace:
    """A profiler's trace reduced to its device operations, each ``(name,
    start_us, end_us)``."""

    def __init__(self, device: List[Tuple[str, float, float]]):
        self.device = sorted(device, key=lambda e: e[1])

    @classmethod
    def load(cls, path: str) -> "Trace":
        """From a Chrome trace that ``torch.profiler`` wrote."""
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        return cls([(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS])

    def kernels(self, needle: str) -> List[Tuple[str, float, float]]:
        """Device operations whose name holds ``needle``."""
        return [e for e in self.device if needle in e[0]]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, merged."""
        out: List[List[float]] = []
        for _, a, b in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_seconds(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def top_device_ops(self, n: int = 10) -> List[List]:
        """The ``n`` device operations that took most time, by name, in
        seconds."""
        by: Dict[str, float] = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k[:NAME_CHARS], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, at_least_us: float = 20.0) -> List[List]:
        """Idle time of the device between its operations, summed by what the
        host was doing in each gap, as the device operation it launched to
        end the gap names it: ``before <op>``.  The ``n`` largest sums, in
        seconds; gaps under ``at_least_us`` are left out."""
        by: Dict[str, float] = {}
        ops = iter(self.device)
        op = next(ops, None)
        busy = self.busy_intervals()
        for (_, end), (start, _) in zip(busy, busy[1:]):
            while op is not None and op[1] < start:
                op = next(ops, None)
            if start - end >= at_least_us and op is not None:
                key = f"before {op[0][:NAME_CHARS]}"
                by[key] = by.get(key, 0.0) + (start - end) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_share(trace: Optional[Trace], window_s: Optional[float]) -> Optional[float]:
    """The share of a traced window in which no operation ran on the
    device, in %; None without a trace or a device operation in it."""
    if trace is None or not window_s or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_seconds() / window_s)


def roofline_share(least_ms_each: Sequence[float], kernels: Iterable[Tuple[str, float, float]]) -> Optional[float]:
    """The least time of the calls over the time their kernels took on the
    device, in %; None where the trace holds no launch of them or a number
    of launches other than the calls counted from the shapes (the mapping
    from calls to launches is then unsound)."""
    spans = list(kernels)
    if not spans or len(spans) != len(least_ms_each):
        return None
    device_ms = sum(b - a for _, a, b in spans) / 1e3
    return 100.0 * sum(least_ms_each) / device_ms
