"""The cost of one step per device, counted on the meta device: the port's
counterpart of the JAX package's ``repro/launch/hlo_cost.py`` (and of
``analysis.collective_bytes``), which read the same numbers off the
compiled, SPMD-partitioned HLO.

``CostMode`` is a ``TorchDispatchMode``.  It lets DTensor run first (it
answers ``NotImplemented`` to an op on DTensors, as
``torch.distributed.tensor.debug.CommDebugMode`` does), so it sees the
ops each rank runs on its local shard, and the collectives DTensor
runs for them, and counts per device:

* FLOPs: each op's count from ``torch.utils.flop_counter``'s formulas
  (the registry ``FlopCounterMode`` reads; matmuls, convolutions and
  attention, not elementwise ops), plus a formula for each of the three
  hand-written kernels, which on meta tensors run no op
  (``kernels.ops.META_OBSERVERS``);
* bytes read and written: every op's tensor inputs and outputs, once
  each, views and uninitialised allocations excepted, and an indexed
  in-place write (a cache slot) twice its source, not its destination;
  the kernels' by their inputs and outputs;
* collective bytes, by kind as ``analysis.COLLECTIVE_OPS`` names them:
  the result bytes of each functional collective;
* kernel calls: how many times each hand-written kernel is called
  (``kernel_calls``) and each distinct call as one device gets it
  (``call_records``): every input's local shape and dtype and the call's
  other arguments, with its count;
* live memory: every storage an op makes, from its creation until it
  is freed, each rounded up to the 512 bytes the CUDA caching allocator
  rounds a block to, on top of the storages registered as the state
  (``track``); the peak is the largest sum, the remat recompute and the
  backward included, and the scratch an op's CUDA kernel holds beside
  its outputs while it runs (``SCRATCH``), which no meta op allocates.

With ``by_op``, the mode also keeps where these come from
(``by_op_report``): the FLOPs of each op (its name, the source line of
the port's model code that ran it, its output's shape) and, at the peak,
the live storages grouped by the op and line that made each.
"""
from __future__ import annotations

import json
import traceback
import weakref
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import ops
from ..tree import leaves
from .analysis import COLLECTIVE_OPS

BLOCK = 512  # bytes: the CUDA caching allocator's rounding of a block

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_UNWRITTEN = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided"}
# in-place writes of a few rows (a cache slot, a dispatch slot): they read
# and write the rows they are given, not the whole destination
_INDEXED_WRITES = {"index_copy_", "index_put_", "index_add_", "scatter_", "scatter_add_",
                   "scatter_reduce_", "index_fill_"}
# Bytes that an op's CUDA kernel allocates for itself beside its outputs,
# freed when it returns, by op: torch's softmax backward forms
# grad * output in a temporary the size of its result before it reduces
# (aten/src/ATen/native/cuda/SoftMax.cu).  Found by the card's
# max_memory_allocated inside each op of a train step against the
# meta count (PERF.md, PR 18); the plain attention backward's is the
# largest tensor of a long-sequence train step.
SCRATCH = {"_softmax_backward_data": lambda outs: sum(allocated_bytes(t.nbytes) for t in outs)}


def allocated_bytes(nbytes: int) -> int:
    """The bytes the caching allocator gives a storage of ``nbytes``."""
    return -(-nbytes // BLOCK) * BLOCK if nbytes else 0


def ssd_flops(B: int, S: int, H: int, P: int, N: int, Q: int) -> int:
    """Operations of the chunked scan: per (b, h, chunk of q <= Q
    positions) 2q^2 N (C B^T) + 2q^2 P (W x) + 4qNP (the carried state's
    output and the state update); the tail chunk counts its q = S % Q."""
    qs = [Q] * (S // Q) + ([S % Q] if S % Q else [])
    return B * H * sum(2 * q * q * N + 2 * q * q * P + 4 * q * N * P for q in qs)


def kernel_flops(name: str, inputs: Dict[str, torch.Tensor]) -> int:
    """Operations of one RMSNorm or flash-attention call: RMSNorm 4 an
    element; flash attention 4 a (query, key, head, dim) for its two
    products, dense (every query against every key, masks aside)."""
    if name == "rmsnorm":
        return 4 * inputs["x"].numel()
    if name == "flash_attention":
        B, Sq, H, K = inputs["q"].shape
        return 4 * B * Sq * H * inputs["k"].shape[1] * K
    raise KeyError(name)


def kernel_call(name: str, inputs: Dict[str, torch.Tensor], attrs: Dict[str, Any]) -> Dict[str, Any]:
    """One kernel call as a device gets it: the kernel, each input's local
    shape and dtype, and the call's other arguments (``attrs``: causal and
    window, chunk and output type, eps); for flash attention also whether
    one ``q_pos`` row is shared by the whole batch."""
    rec: Dict[str, Any] = {"kernel": name, "inputs": {
        k: {"shape": list(t.shape), "dtype": str(t.dtype).split(".")[-1]} for k, t in inputs.items()}}
    rec.update(attrs)
    if name == "flash_attention":
        rec["q_pos_shared"] = inputs["q_pos"].ndim == 1
    return rec


def _origin() -> str:
    """The innermost frame of the port's model code on the stack (for a
    kernel, the line that called its wrapper)."""
    for fr in reversed(traceback.extract_stack()):
        if "repro_torch" in fr.filename and not any(
                d in fr.filename for d in ("/launch/", "/kernels/")):
            return f"{fr.filename.split('repro_torch/')[-1]}:{fr.lineno}"
    return "?"


def _storage_key(t: torch.Tensor) -> Tuple[int, int]:
    st = t.untyped_storage()
    return st._cdata, st.nbytes()


class CostMode(TorchDispatchMode):
    """Counts one step's per-device cost; see the module docstring.
    ``by_op`` keeps the cost by op (``by_op_report``)."""

    def __init__(self, by_op: bool = False):
        super().__init__()
        self.by_op = by_op
        self._flops_by_op: Dict[str, float] = defaultdict(float)
        self._made: Dict[int, str] = {}  # storage -> "op @ line shape dtype"
        self._at_peak: List[Tuple[str, int]] = []
        self._current = "state"
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_OPS}
        self.kernel_calls: Dict[str, int] = {}
        self._call_counts: Dict[str, int] = {}  # kernel_call as JSON -> calls
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # ---- live storages ----------------------------------------------

    def track(self, tree: Any) -> int:
        """Registers the local storage of every tensor of ``tree`` (the
        state alive before the step) and returns their allocated bytes."""
        before = self.live_bytes
        for t in leaves(tree):
            if torch.is_tensor(t):
                self._add(t.to_local() if isinstance(t, DTensor) else t)
        return self.live_bytes - before

    def _add(self, t: torch.Tensor) -> None:
        key, nbytes = _storage_key(t)
        if key in self._live:
            return
        size = allocated_bytes(nbytes)
        self._live[key] = size
        self.live_bytes += size
        if self.by_op:
            self._made[key] = f"{self._current} {tuple(t.shape)} {t.dtype}"
        self._reach(self.live_bytes)
        weakref.finalize(t.untyped_storage(), self._free, key)

    def _reach(self, nbytes: int, scratch: int = 0) -> None:
        if nbytes > self.peak_bytes:
            self.peak_bytes = nbytes
            if self.by_op:  # labels now: a freed storage's key is reused
                self._at_peak = [(self._made.get(k, "state"), n) for k, n in self._live.items()]
                if scratch:
                    self._at_peak.append((f"scratch of {self._current}", scratch))

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # ---- dispatch ---------------------------------------------------

    def __enter__(self):
        ops.META_OBSERVERS.append(self._kernel)
        # DTensor infers each new op's output shapes by running it on meta
        # stand-ins of the *global* tensors: no rank runs those, so they
        # run with this mode off.
        self._propagate = run = ShardingPropagator._propagate_tensor_meta_non_cached

        def unseen(*args, **kwargs):
            with _disable_current_modes():
                return run(*args, **kwargs)

        ShardingPropagator._propagate_tensor_meta_non_cached = unseen
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._propagate_tensor_meta_non_cached = self._propagate
        ops.META_OBSERVERS.remove(self._kernel)
        return super().__exit__(*exc)

    def _kernel(self, name: str, inputs: Dict[str, torch.Tensor], outs, attrs) -> None:
        before = self.flops
        if name == "ssd_scan":
            x, Bm = inputs["x"], inputs["B"]
            B, S, H, P = x.shape
            self.flops += ssd_flops(B, S, H, P, Bm.shape[-1], attrs["chunk"])
        else:
            self.flops += kernel_flops(name, inputs)
        if self.by_op:
            self._flops_by_op[f"kernel {name} @ {_origin()}"] += self.flops - before
        self.bytes += sum(t.nbytes for t in (*inputs.values(), *outs))
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        key = json.dumps(kernel_call(name, inputs, attrs), sort_keys=True)
        self._call_counts[key] = self._call_counts.get(key, 0) + 1

    def call_records(self) -> List[Dict[str, Any]]:
        """Each distinct kernel call (``kernel_call``) with its ``count``,
        in the order of first call."""
        return [{**json.loads(key), "count": n} for key, n in self._call_counts.items()]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor run, then see its local ops
        kwargs = kwargs or {}
        packet = func._overloadpacket
        name = packet.__name__
        if self.by_op:
            self._current = f"{name} @ {_origin()}"
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if torch.is_tensor(t)]
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            if self.by_op:
                self._flops_by_op[f"{self._current} -> {tuple(outs[0].shape) if outs else ()}"] += n
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            self.coll[_COLLECTIVES[name]] += sum(t.nbytes for t in outs)
        ins = [t for t in tree_flatten((args, kwargs))[0] if torch.is_tensor(t)]
        if name in _INDEXED_WRITES:
            self.bytes += 2 * sum(t.nbytes for t in ins[1:])
        elif not func.is_view and name not in _UNWRITTEN:
            self.bytes += sum(t.nbytes for t in (*ins, *outs))
        for t in outs:
            self._add(t)
        if name in SCRATCH:
            scratch = SCRATCH[name](outs)
            self._reach(self.live_bytes + scratch, scratch)
        return out

    def by_op_report(self, top: int = 12) -> Dict[str, List[Dict[str, Any]]]:
        """The ``top`` ops by FLOPs (each with its share of the total) and,
        at the peak, the ``top`` groups of live storages by the op, line,
        shape and dtype that made them (``"state"``: tracked before the
        step).  Needs ``by_op``."""
        if not self.by_op:
            raise ValueError("CostMode(by_op=True) keeps the cost by op")
        ops_ = sorted(self._flops_by_op.items(), key=lambda kv: -kv[1])[:top]
        live: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
        for made_by, n in self._at_peak:
            group = live[made_by]
            group[0] += n
            group[1] += 1
        biggest = sorted(live.items(), key=lambda kv: -kv[1][0])[:top]
        return {
            "flops_by_op": [{"op": k, "flops": v, "share": v / self.flops} for k, v in ops_],
            "live_at_peak": [{"made_by": k, "bytes": v[0], "count": v[1]} for k, v in biggest],
        }

    @property
    def coll_bytes(self) -> float:
        return float(sum(self.coll.values()))


def state_bytes(tree: Any, allocated: bool = True) -> int:
    """Per-device bytes of a tree's local tensors (each storage once),
    rounded as the allocator rounds them when ``allocated``."""
    seen: Dict[int, int] = {}
    for t in leaves(tree):
        if torch.is_tensor(t):
            key, nbytes = _storage_key(t.to_local() if isinstance(t, DTensor) else t)
            seen[key] = allocated_bytes(nbytes) if allocated else nbytes
    return sum(seen.values())
