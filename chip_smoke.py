#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device   — a CUDA device of capability (9, 0); prints the card's name
                and power limit as nvidia-smi reports them.
  2. build    — compiles the port's CUDA kernels from src/repro_torch/csrc.
  3. kernels  — each kernel (RMSNorm, flash attention, SSD scan) against its
                plain PyTorch version on the card, at the main paths'
                shapes (serving and training), with times (kernel, plain,
                one PyTorch library call as a yardstick where one exists)
                and the bound; the timer's floor (the smallest RMSNorm
                launch); SSD scans must give the same bits twice.  Flash
                outputs are also held row by row (relative L2 of each
                query row <= 1e-2 in bf16, 1e-4 in fp32), and the new
                cases show that planted faults (a wrong mask, window or
                scale, the ring's wrapped slots dropped) break that bound.
                Flash runs at head_dim 16 too, the reduced configs' width,
                on every route (decode over 4,096 slots, causal and
                windowed prefills of 2,048, the reduced model's own calls).
                The flash backward kernels (bf16) at the train paths'
                shapes (deepseek-7b.train_8k's, the families') against the
                plain recompute they replace (FLASH_BWD_TOL), the same bits
                twice, timed beside the plain version and SDPA's backward.
  4. serve    — main path 1: full-width, 30-layer deepseek-7b in bf16 from
                a seeded generator; ServeEngine(max_len=512, batch_size=4)
                serves 6 requests of 16 new tokens; every forward pass must
                launch 61 RMSNorm and 30 attention kernels, a prefill's
                through the tensor-core route (mma_prefill), a decode
                step's through the decode route.
  5. checks   — prefill/decode consistency at full width, and reduced
                deepseek-7b (head_dim 16, fp32) on the card against the
                same model on the CPU (plain path); its prefill takes
                "fma K=16 causal", its decode steps "decode K=16 causal".
  6. calibrate — a profiled decode step (device busy share, time by kernel)
                and the decode-step latency curve at batch 1, 8, 32, 128;
                then the same recipe on reduced deepseek-7b (fp32, head_dim
                16), the config the reference's default curve was measured
                on under CPU JAX: every decode step "decode K=16 causal".
  7. ssm      — main path 2: full-width, 48-layer mamba2-370m in bf16;
                ServeEngine(max_len=512, batch_size=4) serves 6 requests
                (prompts of 1 to 300 tokens) of 16 new tokens; every pass
                launches 97 RMSNorm kernels, every prefill 48 SSD scans (all
                on the tensor-core route, mma) and no decode step any.
                Then its prefill/decode consistency, a small SSM model on
                the card against the CPU, a profiled decode step, and a
                profiled prefill of the 300-token prompt (device time by
                kernel, the SSD scan's share).
  8. moe      — main path 5: full-width, 48-layer qwen3-moe-30b-a3b in bf16
                (30.5 G parameters, 128 experts, top-8, qk-norm, 32 query
                heads on 4 KV heads); ServeEngine(max_len=512, batch_size=4)
                serves 6 requests of 16 new tokens; every pass launches 193
                RMSNorm (ln1, ln2, q-norm, k-norm a layer, the final norm)
                and 48 attention kernels, a prefill's through mma_prefill, a
                decode step's through decode; each prefill's dropped (token,
                k) pairs are logged.  Then its prefill/decode consistency
                (capacity raised so that no pair drops), a small MoE model
                on the card against the CPU (the same experts and the same
                dropped pairs, some dropped), a profiled decode step (the
                expert products against their byte bound) and the
                calibrated curve.  Then the same on full-width, 48-layer
                moonshot-v1-16b-a3b (28.06 G parameters, 64 experts, top-6,
                16 query heads on 16 KV heads; 97 RMSNorm and 48 attention
                kernels a pass), serving 4 requests, without the curve.
                The MoE consistency check counts the routing choices that
                differ between the two paths (bf16 near-ties), and holds
                the bound again with the split path's routing pinned to
                the full prefill's.
  9. train    — main path 3: deepseek-7b at full width, depth cut to 8
                layers (fp32 AdamW moments for 30 would not fit), bf16,
                3 steps of make_train_step at batch 4 x seq 512; every step
                launches 33 RMSNorm and 16 attention kernels (forward and
                the remat recompute), all on mma_prefill; a profiled step.
                Then qwen3-moe-30b-a3b the same way at 4 of 48 layers: 33
                RMSNorm (four norms a layer) and 8 attention kernels a
                step, each step's dropped pairs and aux logged, the peak
                against its reckoning.  Main path 4: mamba2-370m at full
                width and depth through train_loop, 4 steps at batch 8 x
                seq 512; every step 193 RMSNorm and 96 SSD scans, all on
                mma.  The dense and MoE steps (and hubert's, phase 10) make
                one backward a layer, each on the backward kernels
                (ops.FLASH_BWD).  Finite losses and grad norms, the step-0
                cross-entropy near its expected value; small models
                (reduced deepseek-7b, mamba2-370m and the two MoE configs,
                whose routing must be the same on both) trained on the card
                against the CPU; a failed and resumed train_loop against a
                straight run.
 10. families — main path 6: full-width, 32-layer llava-next-mistral-7b
                in bf16: a prefill of 2 rows of 1,152 image embeddings and
                200 text tokens (1,352 rows each), 16 decode steps; the
                last step against a prefill of the whole sequence.  Main
                path 7: full-width, 48-layer hubert-xlarge (head_dim 80,
                non-causal): a prefill over 8 x 500 frames, then 3 train
                steps at that batch on masked-frame labels; a prefill
                through the kernels against the plain versions.  Main path
                8: full-width, 24-layer h2o-danube-3-4b (head_dim 120,
                window 4096): 8,192 tokens prefilled into a 4,096-slot
                ring, 16 decode steps across its wrap, each against a
                cache-free forward.  Every pass's launches are counted by
                route, head dim and mask (ops.FLASH_SHAPES), and each path
                is profiled.  The hybrid jamba-1.5-large-398b (398 G
                parameters, more than one card holds) runs cut to its
                reduced config (head_dim 16) in fp32: prefill and decode
                on the card against the CPU (the same routing), then
                ServeEngine, its tokens against the CPU engine's.
 10b. dense  — main path 1 on the dense giants: full-width qwen3-32b (64
                layers, d_model 5120, qk-norm, 64 query heads on 8 KV heads;
                65.5 GB in bf16) and granite-34b (88 layers, d_model 6144,
                48 query heads on one KV head, the non-gated GeLU MLP; 67.9
                GB), each freed before the next; ServeEngine(max_len=512,
                batch_size=4) serves 4 requests of 16 new tokens, every pass
                launching 257 and 177 RMSNorm and 64 and 88 attention
                kernels (mma_prefill, decode); prefill/decode consistency,
                a profiled decode step, and the reduced config (head_dim
                16, fp32) on the card against the CPU.
 10c. jamba   — the hybrid at its own widths (d_model 8192, 64 query heads
                on 8 KV heads of 128, 256 SSM heads of 64, ssm_state 128, 16
                experts top-2) in bf16, cut to one super-block of 8 layers
                with MoE on every 4th (jamba_cut_config: 27.03 G parameters);
                init's peak against its reckoning; ServeEngine(max_len=512,
                batch_size=4) serves 4 requests of 16 new tokens, every pass
                24 RMSNorm and one flash launch (mma_prefill, decode), every
                prefill 7 SSD scans on mma; each prefill's dropped pairs;
                prefill/decode consistency with capacity raised; a 1 x 200
                prefill through the kernels against the plain versions with
                the routing pinned; a profiled decode step.  Then the mid
                width (d_model 256, head_dim 64, ssm_state 64): in bf16
                through the kernels (mma_prefill, mma) against the plain
                versions on the card, and in fp32 against the CPU with the
                same routing.
 11. parallel — the dry run (repro_torch.launch.dryrun) of every cell
                (each arch at each of its shapes, 32; the train cells under
                sp) on a fake 16x16 mesh (256 ranks), started in three
                spawned worker processes when the run begins and collected
                here, a line per cell: fits_h100 (which every cell must),
                the per-device peak, FLOPs, collective bytes, the
                bottleneck, and each distinct kernel call the cell hands a
                device, at its local shapes; each train cell's peak and
                FLOPs within TRAIN_RECORD_TOL of torch 2.13's count
                (TRAIN_RECORD_2_13), whatever torch runs, and DRYRUN_CALLS
                distinct calls over the cells.  Every
                distinct call of these cells is replayed on the card from
                seeded inputs at those shapes against its plain version
                (row error within PLAIN_TOL), with the route the launch
                counters saw it take (RMSNorm's too), its ms and its bound;
                each of the three kernels must be among them.  Then, on a
                one-rank NCCL group and a (1, 1) cuda mesh, with params, state, cache and batch as DTensors placed
                by the sharding rules, seven cells against their dry run on
                the meta device at the same cut: mamba2-370m and
                h2o-danube-3-4b at long_500k (one decode step, uncut),
                deepseek-7b at decode_32k (batch 2), mamba2-370m at train_4k
                (batch 8: loss, grads, AdamW), deepseek-7b at train_4k
                (batch 2, 8 layers), qwen3-moe-30b-a3b at decode_32k
                (batch 2) under moe_a2a, whose logits must equal apply_moe's
                bit for bit, and qwen3-moe-30b-a3b at prefill_32k (batch 1:
                32,768 tokens through the placed MoE dispatch, whose first
                layer's routing, output and aux must equal apply_moe's on
                the plain tensors bit for bit).  In one step of each cell
                every kernel call is held against its plain version on the
                same inputs (row error within PLAIN_TOL; a decode cache
                drawn at random; the plain attention in chunks of query
                rows), and
                phase 3 holds each kernel at these cells' shapes.  Each
                holds the state's bytes
                (requested exactly; allocated within the allocator's
                rounding), the step's peak (measured / predicted in
                PEAK_BAND, on a step whose flash backward is the plain
                recompute the dry run prices; the timed steps, on the
                backward kernels, peak no higher), FLOPs and roofline
                time against the median of 5 steps, and every step's
                launches by kernel, route, head dim
                and mask, all through the wrappers' DTensor branch, and
                one more step profiled (device time by kernel kind).
 12. sched    — the main path's last link: the port's scheduler core
                (repro_torch.core, numpy on the host) runs the CI fleet
                regime of benchmarks/sched_scale.py (64 perturbed variants
                of 300 jobs on 16 servers), whose per-variant digests and
                fleet digest must equal benchmarks/BENCH_fleet_baseline.json's,
                its wall time logged beside the card; then the --serve
                regime of benchmarks/sched_scale.py (400 jobs, 16 servers,
                one diurnal stream of 100 requests/s, SLO 0.2 s) on the
                default service curve, where both schedule digests must
                equal benchmarks/BENCH_serve_baseline.json's, then on the
                curves calibrated in phases 6 (deepseek-7b, full width and
                reduced) and 8 (qwen3-moe-30b-a3b): SLO attainment, p50/p99, train
                interference, preemptions, digests and wall time for each,
                beside the card's name and power limit.
Then one line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

    python3 chip_smoke.py --only rmsnorm,ssd,prefill_profile --src DIR

runs phases 1-3 for the named kernels ("flash_bwd": the flash backward
cases) (and the profiled prefill, phase 10c for "jamba", phase 11's dry
run and replay for "replay", all of phase 11 for "parallel", or for
"sched" deepseek-7b's calibrated curves, full width and reduced, and phase
12 on them) on the port in DIR/src, then stops: two trees' kernels timed
in one chip call.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
L2_FLUSH_BYTES = 64 << 20  # more than the 50 MB L2: every timed launch starts cold
SPIN_CYCLES = 40_000_000  # about 20 ms of device time at the H100's clock
SPIN_HZ = 2.0e9  # above the H100's top SM clock, so a spin lasts at least cycles / SPIN_HZ


def log(*args) -> None:
    print(*args, flush=True)


# --------------------------------------------------------------------------
# timing and bounds
# --------------------------------------------------------------------------


class Timer:
    def __init__(self, torch, device):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)
        torch.cuda._sleep(1000)  # load the spin kernel before any timing
        self.flush.zero_()
        torch.cuda.synchronize()

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        """Median device time of one call, from CUDA events, with the L2
        cache flushed before each call.  A spin kernel keeps the device busy
        while the host queues every call, so host overhead between the
        events does not count; it lasts at least twice the host time of
        one synchronised call per timed call, enough for a plain version
        whose host time exceeds its device time."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.flush.zero_()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        torch.cuda._sleep(max(SPIN_CYCLES, int(2 * iters * host_s * SPIN_HZ)))
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        times = sorted(s.elapsed_time(e) for s, e in pairs)
        return times[len(times) // 2]


def bound(bytes_moved: float, flops: float, dtype: str):
    """(least ms, "bytes" or "operations"): the H100 data sheet's rates,
    kept in repro_torch/launch/analysis.py."""
    from repro_torch.launch.analysis import HBM_BYTES_PER_S, PEAK_FLOPS

    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rmsnorm_bound(x):
    """``bound`` of one RMSNorm call: x read and y written once, the fp32
    scale read once, 4 operations an element."""
    D = x.shape[-1]
    rows = x.numel() // D
    return bound(rows * D * 2 * x.element_size() + 4 * D, 4 * rows * D, "float32")


def visible_pairs(torch, q, k, q_pos, kv_pos, causal, window):
    """(visible (query, key) pairs summed over the batch, keys some query
    sees summed over the batch) of one flash-attention call on this data, a
    row that sees no key seeing (and averaging) all T.  The mask is formed
    over query rows in chunks of FLASH_PLAIN_BYTES."""
    from repro_torch.kernels import ref

    B, Sq = q.shape[:2]
    T = k.shape[1]
    rows = max(1, FLASH_PLAIN_BYTES // (B * T))
    pairs, seen = 0, torch.zeros(B, T, dtype=torch.bool, device=q.device)
    for i in range(0, Sq, rows):
        m = ref.attention_mask(q_pos[..., i:i + rows], kv_pos, causal, window)
        m = m.expand(B, *m.shape[-2:])
        m = m | ~m.any(dim=-1, keepdim=True)
        pairs += int(m.sum())
        seen |= m.any(dim=1)
    return pairs, int(seen.sum())


def flash_bound(torch, q, k, q_pos, kv_pos, causal, window):
    """``bound`` of one flash-attention call on this data: q read and the
    output written once, each key and value row that some query sees read
    once, and the positions; 4 K H operations a visible (query, key) pair
    (``visible_pairs``)."""
    H, K = q.shape[2:]
    G = k.shape[2]
    pairs, seen = visible_pairs(torch, q, k, q_pos, kv_pos, causal, window)
    esize = q.element_size()
    moved = 2 * q.numel() * esize + 2 * seen * G * K * esize + 4 * (q_pos.numel() + kv_pos.numel())
    return bound(moved, 4 * K * H * pairs, str(q.dtype).split(".")[-1])


def flash_bwd_bound(torch, q, k, q_pos, kv_pos, causal, window):
    """``bound`` of one flash-attention backward call: 10 K H operations a
    visible pair (five products of the forward's size: S, dP, dV, dQ and
    dK); q, the output and its gradient read and dq written, each key and
    value row some query sees read and its dk and dv written."""
    H, K = q.shape[2:]
    G = k.shape[2]
    pairs, seen = visible_pairs(torch, q, k, q_pos, kv_pos, causal, window)
    esize = q.element_size()
    moved = 4 * q.numel() * esize + 4 * seen * G * K * esize + 4 * (q_pos.numel() + kv_pos.numel())
    return bound(moved, 10 * K * H * pairs, str(q.dtype).split(".")[-1])


def ssd_bound(torch, x, Bm, chunk, init_state, out_dtype):
    """``bound`` of one SSD-scan call: x, dt, A, B and C read and y and the
    final state written once (the initial state read too, if given); the
    operations of ``launch/cost.py``'s ``ssd_flops``."""
    from repro_torch.launch.cost import ssd_flops

    B, S, H, P = x.shape
    N = Bm.shape[-1]
    esize = x.element_size()
    ysize = torch.empty((), dtype=out_dtype).element_size()
    moved = (B * S * H * P * (esize + ysize) + 4 * B * S * H + 4 * H + 2 * B * S * N * esize
             + 4 * B * H * N * P * (2 if init_state is not None else 1))
    return bound(moved, ssd_flops(B, S, H, P, N, chunk), str(x.dtype).split(".")[-1])


def ssd_dt_A(torch, shape, gen, dev):
    """The SSD scan's dt (``shape`` [B, S, H]) in [0.001, 0.1) and A [H] in
    (-4, -0.5], drawn from ``gen``."""
    dt = torch.rand(shape, generator=gen, device=dev) * 0.099 + 0.001
    A = -(torch.rand(shape[-1], generator=gen, device=dev) * 3.5 + 0.5)
    return dt, A


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def rmsnorm_cases(torch, ops, ref, timer, dev):
    import torch.nn.functional as F

    out = []
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [  # dtype, rows, D
        # one row of qk-norm width: the timer's floor (a launch with the L2 cold)
        ("bfloat16", 1, 128),
        # deepseek-7b: a decode step's rows, a 37-token prompt, a long prefill
        ("bfloat16", 8, 4096), ("bfloat16", 37, 4096), ("bfloat16", 4096, 4096),
        ("float32", 8, 4096), ("float32", 37, 4096), ("float32", 4096, 4096),
        # mamba2-370m: d_model 1024 and the gated norm over d_inner 2048, at a
        # decode step of the serve batch (4 rows) and the longest prompt (300)
        ("bfloat16", 4, 1024), ("bfloat16", 300, 1024),
        ("bfloat16", 4, 2048), ("bfloat16", 300, 2048),
        # the training steps' rows: deepseek-7b at batch 4 x 512, mamba2-370m
        # at batch 8 x 512
        ("bfloat16", 2048, 4096), ("bfloat16", 4096, 1024), ("bfloat16", 4096, 2048),
        # qwen3-moe-30b-a3b's q-norm: a decode step of 4 (4 x 32 heads) and a
        # 300-token prefill (300 x 32); its d_model 2048 is mamba2-370m's d_inner
        ("bfloat16", 128, 128), ("bfloat16", 9600, 128),
        # the general kernel's widths: hubert-xlarge's prefill and train step
        # (8 x 500 frames of 1280), h2o-danube-3-4b's 8192-token prefill (3840),
        # qwen3-32b's d_model 5120 and granite-34b's 6144 at 4 x 512 tokens
        ("bfloat16", 4000, 1280), ("bfloat16", 8192, 3840),
        ("bfloat16", 2048, 5120), ("bfloat16", 2048, 6144),
        # jamba-1.5-large-398b's d_model 8192 and its gated norm over d_inner
        # 16384, at a prefill of 4 x 512 tokens: the general kernel
        ("bfloat16", 2048, 8192), ("bfloat16", 2048, 16384),
    ]
    for dtype, rows, D in cases:
        tdt = getattr(torch, dtype)
        x = torch.randn(rows, D, generator=gen, device=dev).to(tdt)
        scale = torch.randn(D, generator=gen, device=dev)
        got = ops.rmsnorm(x, scale)
        want = ref.rmsnorm_ref(x, scale)
        torch.cuda.synchronize()
        tol = 1e-5 if dtype == "float32" else 2e-2
        err = (got.float() - want.float()).abs().max().item()
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        w = scale.to(tdt)
        b_ms, b_by = rmsnorm_bound(x)
        out.append(dict(
            kernel="rmsnorm", case=f"{dtype} rows={rows} D={D}",
            max_abs_err=err, tol=tol, ok=ok,
            ms=timer.ms(lambda: ops.rmsnorm(x, scale)),
            plain_ms=timer.ms(lambda: ref.rmsnorm_ref(x, scale)),
            library_ms=timer.ms(lambda: F.rms_norm(x, (D,), w, 1e-6)),
            bound_ms=b_ms, bound_by=b_by,
        ))
    log(f"timer floor: {out[0]['ms']!r} ms, the median time of the smallest RMSNorm launch "
        f"({out[0]['case']}, bound {out[0]['bound_ms']!r} ms)")
    return out


def rel_rows(got, want, keep: int) -> float:
    """The largest relative L2 error of a row of ``got`` against ``want``,
    a row being one index of the first ``keep`` dims (a flash output's
    query row, a normed row, a scan position or state head)."""
    d = (got.float() - want.float()).flatten(keep).norm(dim=-1)
    err = (d / want.float().flatten(keep).norm(dim=-1).clamp_min(1e-30)).max().item()
    return err if err == err else float("inf")  # NaN: no agreement


def _scaled_q(q, K):
    """q such that the reference's K**-0.5 acts as 128**-0.5: the scale of
    a kernel that used its padded width in place of the true head dim."""
    return (q.float() * (K / 128) ** 0.5).to(q.dtype)


# Faults a kernel could plant in the new flash cases, as arguments
# (q, q_pos, kv_pos, causal, window) of the plain version; the row check of
# each case must tell every one of them from the sound kernel.
PLANTED_FAULTS = {
    "audio_prefill": lambda q, qp, kp, w: {
        "causal mask": (q, qp, kp, True, w),
        "scale 128^-0.5": (_scaled_q(q, 80), qp, kp, False, w),
    },
    "swa_prefill": lambda q, qp, kp, w: {
        "no window": (q, qp, kp, True, None),
        "window - 1": (q, qp, kp, True, w - 1),
        "window + 1": (q, qp, kp, True, w + 1),
        "scale 128^-0.5": (_scaled_q(q, 120), qp, kp, True, w),
    },
    "swa_decode_wrapped": lambda q, qp, kp, w: {
        # the 16 slots written after the ring wrapped (positions past 8191)
        "wrapped slots dropped": (q, qp, kp.masked_fill(kp >= 8192, -1), True, w),
        "scale 128^-0.5": (_scaled_q(q, 120), qp, kp, True, w),
    },
}


def flash_cases(torch, ops, ref, timer, dev):
    import torch.nn.functional as F

    i32 = dict(dtype=torch.int32, device=dev)
    ar = torch.arange(512, **i32)
    decode_q = torch.tensor([17, 63, 128, 200, 255, 301, 390, 447], **i32)[:, None]
    decode_kv = torch.where(ar < 448, ar, -1)
    # the serve run's decode: rows at their own depths in one max_len-512
    # cache written up to the deepest row, -1 beyond
    serve_q = torch.tensor([215, 20, 98, 176], **i32)[:, None]
    serve_kv = torch.where(ar < 216, ar, -1)
    cases = [
        # name, B, Sq, T, H, G, K, dtype, window, q_pos, kv_pos
        ("prefill", 1, 37, 37, 32, 32, 128, "bfloat16", None, None, None),
        ("prefill", 1, 256, 256, 32, 32, 128, "bfloat16", None, None, None),
        ("decode", 8, 1, 512, 32, 32, 128, "bfloat16", None, decode_q, decode_kv),
        ("gqa", 2, 256, 256, 32, 8, 128, "bfloat16", None, None, None),
        ("head_dim_64", 2, 100, 300, 16, 16, 64, "float32", None, None, None),
        ("window", 1, 256, 256, 32, 32, 128, "bfloat16", 96, None, None),
        ("fully_masked", 1, 1, 100, 32, 32, 128, "float32", None,
         torch.tensor([5], **i32), torch.full((100,), -1, **i32)),
        # the deepseek-7b serve run's own shapes
        ("decode_serve", 4, 1, 512, 32, 32, 128, "bfloat16", None, serve_q, serve_kv),
        ("decode", 1, 1, 512, 32, 32, 128, "bfloat16", None, decode_q[-1:], decode_kv),
        ("prefill", 1, 200, 200, 32, 32, 128, "bfloat16", None, None, None),  # longest prompt
        ("decode_gqa", 8, 1, 512, 32, 8, 128, "bfloat16", None, decode_q, decode_kv),
        ("train", 4, 512, 512, 32, 32, 128, "bfloat16", None, None, None),  # deepseek-7b's step
        # qwen3-moe-30b-a3b's serve run: 8 query heads a KV head
        ("decode_moe", 4, 1, 512, 32, 4, 128, "bfloat16", None, serve_q, serve_kv),
        ("prefill_moe", 1, 200, 200, 32, 4, 128, "bfloat16", None, None, None),
    ]
    cases = [c + (True,) for c in cases]  # all causal
    # h2o-danube-3-4b's decode after 16 tokens wrapped its 4096-slot ring
    ring = torch.arange(4096, **i32)
    ring_kv = torch.where(ring < 16, ring + 8192, ring + 4096)  # 8192..8207, then 4112..8191
    # phase 11's decode cells: both rows at the last of 32,768 written slots
    last_q = torch.full((2, 1), 32767, **i32)
    full_kv = torch.arange(32768, **i32)
    cases += [  # name, B, Sq, T, H, G, K, dtype, window, q_pos, kv_pos, causal
        # the vlm, audio and sliding-window paths' own calls
        ("vlm_prefill", 2, 1352, 1352, 32, 8, 128, "bfloat16", None, None, None, True),
        ("audio_prefill", 8, 500, 500, 16, 16, 80, "bfloat16", None, None, None, False),
        ("swa_prefill", 1, 8192, 8192, 32, 8, 120, "bfloat16", 4096, None, None, True),
        ("swa_decode_wrapped", 1, 1, 4096, 32, 8, 120, "bfloat16", 4096,
         torch.tensor([8207], **i32), ring_kv, True),
        # granite-34b's MQA: 48 query heads on one KV head
        ("mqa_decode", 4, 1, 512, 48, 1, 128, "bfloat16", None, serve_q, serve_kv, True),
        ("mqa_prefill", 1, 200, 200, 48, 1, 128, "bfloat16", None, None, None, True),
        # granite-34b's prefill at 4 x 512 tokens, and moonshot-v1-16b-a3b's
        # decode (16 query heads on 16 KV heads: one query head a group)
        ("mqa_prefill", 4, 512, 512, 48, 1, 128, "bfloat16", None, None, None, True),
        ("decode_moonshot", 4, 1, 512, 16, 16, 128, "bfloat16", None, serve_q, serve_kv, True),
        # deepseek-7b and qwen3-moe-30b-a3b x decode_32k at batch 2 (phase 11)
        ("decode_32k", 2, 1, 32768, 32, 32, 128, "bfloat16", None, last_q, full_kv, True),
        ("decode_32k_moe", 2, 1, 32768, 32, 4, 128, "bfloat16", None, last_q, full_kv, True),
        # jamba-1.5-large-398b's attention layer: 64 query heads on 8 KV
        # heads, a prefill of 4 x 512
        ("prefill_jamba", 4, 512, 512, 64, 8, 128, "bfloat16", None, None, None, True),
    ]
    # head_dim 16, the reduced configs' width: decode over 4,096 slots with
    # rows at their own depths, long causal and windowed prefills, and the
    # reduced deepseek-7b's own calls (fp32): a prefill of 3 x 12 tokens into
    # a 32-slot cache, and a decode step of the calibrated curve's largest
    # batch (128 rows at slot 24 of 64)
    k16_q = (torch.arange(1, 9, **i32) * 512 - 1)[:, None]
    k16_kv = torch.arange(4096, **i32)
    ar32, ar64 = torch.arange(32, **i32), torch.arange(64, **i32)
    cases += [
        ("decode_k16", 8, 1, 4096, 32, 8, 16, "float32", None, k16_q, k16_kv, True),
        ("decode_k16", 8, 1, 4096, 32, 8, 16, "bfloat16", None, k16_q, k16_kv, True),
        ("prefill_k16", 4, 2048, 2048, 32, 8, 16, "bfloat16", None, None, None, True),
        ("prefill_k16", 4, 2048, 2048, 32, 8, 16, "bfloat16", 256, None, None, True),
        ("reduced_prefill_k16", 3, 12, 32, 4, 2, 16, "float32", None,
         torch.arange(12, **i32), torch.where(ar32 < 12, ar32, -1), True),
        ("reduced_decode_k16", 128, 1, 64, 4, 2, 16, "float32", None,
         torch.full((128, 1), 24, **i32), torch.where(ar64 <= 24, ar64, -1), True),
    ]
    gen = torch.Generator(device=dev).manual_seed(2)
    out = []
    for name, B, Sq, T, H, G, K, dtype, window, qpos, kvpos, causal in cases:
        tdt = getattr(torch, dtype)
        q = torch.randn(B, Sq, H, K, generator=gen, device=dev).to(tdt)
        k = torch.randn(B, T, G, K, generator=gen, device=dev).to(tdt)
        v = torch.randn(B, T, G, K, generator=gen, device=dev).to(tdt)
        if qpos is None:
            qpos = torch.arange(T - Sq, T, **i32)
            kvpos = torch.arange(T, **i32)
        got = ops.flash_attention(q, k, v, qpos, kvpos, causal, window)
        want = ref.flash_attention_ref(q, k, v, qpos, kvpos, causal, window)
        torch.cuda.synchronize()
        tol = 2e-5 if dtype == "float32" else 2e-2
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got.float(), want.float(), atol=tol, rtol=tol
        )
        if name == "fully_masked":  # -1e30 semantics: the mean of v, not NaN
            mean_v = v.float().mean(1).repeat_interleave(H // G, dim=1)[:, None]
            ok = ok and torch.allclose(got.float(), mean_v, atol=tol, rtol=tol)
        # each query row at its own scale: a row that averages thousands of
        # keys has outputs near 0.02, far below the absolute tolerance
        rel_tol = 1e-4 if dtype == "float32" else 1e-2
        rel = rel_rows(got, want, 2)
        ok = ok and rel <= rel_tol
        faults = {}
        if name in PLANTED_FAULTS:  # the check must catch each of these
            for fault, (fq, fqp, fkp, fc, fw) in PLANTED_FAULTS[name](q, qpos, kvpos, window).items():
                faults[fault] = rel_rows(ref.flash_attention_ref(fq, k, v, fqp, fkp, fc, fw), want, 2)
            ok = ok and min(faults.values()) > rel_tol

        b_ms, b_by = flash_bound(torch, q, k, qpos, kvpos, causal, window)
        lib_ms = None
        if name != "fully_masked":  # SDPA gives NaN for a row with no key
            mask = ref.attention_mask(qpos, kvpos, causal, window)  # [Sq,T] or [B,Sq,T]
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            attn_mask = mask[None, None] if mask.ndim == 2 else mask[:, None]
            gqa = {"enable_gqa": True} if H != G else {}
            lib_ms = timer.ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=attn_mask, **gqa))
        del want
        out.append(dict(
            kernel="flash_attention",
            case=f"{name} {dtype} B={B} Sq={Sq} T={T} H={H} G={G} K={K}"
                 + (f" window={window}" if window else "") + ("" if causal else " non-causal"),
            route=ops._flash_route(Sq, tdt),
            max_abs_err=err, tol=tol, row_rel_l2=rel, rel_tol=rel_tol,
            **({"planted_fault_row_rel_l2": faults} if faults else {}), ok=ok,
            ms=timer.ms(lambda: ops.flash_attention(q, k, v, qpos, kvpos, causal, window)),
            plain_ms=timer.ms(lambda: ref.flash_attention_ref(q, k, v, qpos, kvpos, causal, window)),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        ))
    return out


# The backward kernels against the plain recompute (the fp32 gradient of the
# plain version, the path they replace): each gradient's relative L2 error
# over the whole tensor.  bf16 P and dS in the products and the bf16
# output add about 2^-9 a term; on an H100 the kernels read 0.0023-0.0034
# at every shape tried (PERF.md §6), the plain path's own bf16 rounding
# 0.0016-0.0033 against the fp32 arithmetic.  A row's relative error is no
# test here: a causal row's gradient can be 0 in exact arithmetic (the
# first query's dq), which bf16 rounding leaves near 0.
FLASH_BWD_TOL = 1e-2


def flash_bwd_cases(torch, ops, ref, timer, dev):
    """Phase 3's backward cases: the bf16 backward kernels
    (``ops._flash_attention_bwd_kernel``, the backward alone on the
    forward kernel's output) at the train paths' shapes against the plain
    recompute (``ops._vjp`` of ``ref.flash_attention_ref``, the backward of
    float32 calls) within FLASH_BWD_TOL, the same bits twice; with times
    (kernel, plain, SDPA's backward as the yardstick) and the bound."""
    import torch.nn.functional as F

    i32 = dict(dtype=torch.int32, device=dev)
    cases = [  # name, B, S, H, G, K, window, causal
        ("train_8k", 2, 4096, 32, 32, 128, None, True),  # deepseek-7b.train_8k's call
        ("train", 4, 512, 32, 32, 128, None, True),  # phase 9's deepseek-7b step
        ("train_moe", 4, 512, 32, 4, 128, None, True),  # qwen3-moe-30b-a3b, G=4
        ("train_jamba", 4, 512, 64, 8, 128, None, True),  # jamba's attention, G=8
        ("train_swa", 1, 4096, 32, 8, 120, 1024, True),  # h2o-danube-3-4b, K=120 windowed
        ("train_audio", 8, 500, 16, 16, 80, None, False),  # hubert-xlarge, K=80 non-causal
        ("train_k16", 4, 2048, 32, 8, 16, None, True),  # the reduced configs' width in bf16
    ]
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for name, B, S, H, G, K, window, causal in cases:
        q = torch.randn(B, S, H, K, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, G, K, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, G, K, generator=gen, device=dev).bfloat16()
        pos = torch.arange(S, **i32)
        o = ops.flash_attention(q, k, v, pos, pos, causal, window)
        do = torch.randn(B, S, H, K, generator=gen, device=dev).bfloat16()

        def kernel():
            return ops._flash_attention_bwd_kernel(q, k, v, o, do, pos, pos, causal, window)

        def plain():
            return ops._vjp(
                lambda q_, k_, v_: ref.flash_attention_ref(q_, k_, v_, pos, pos, causal, window),
                (q, k, v), (True,) * 3, (do,))

        got, again = kernel(), kernel()
        want = plain()
        torch.cuda.synchronize()
        errs = [((a.float() - b.float()).norm() / b.float().norm()).item()
                for a, b in zip(got, want)]
        errs = [e if e == e else float("inf") for e in errs]  # NaN: no agreement
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        ok = same and all(bool(t.isfinite().all()) for t in got) and max(errs) <= FLASH_BWD_TOL
        del got, again, want
        # SDPA's backward: its flash path where it takes the mask (causal, no window)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        mask = {"is_causal": causal} if window is None else {
            "attn_mask": ref.attention_mask(pos, pos, causal, window)}
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=H != G, **mask)
        lib_do = do.transpose(1, 2)
        lib_ms = timer.ms(
            lambda: torch.autograd.grad(lib_out, (qt, kt, vt), lib_do, retain_graph=True))
        del lib_out
        b_ms, b_by = flash_bwd_bound(torch, q, k, pos, pos, causal, window)
        out.append(dict(
            kernel="flash_attention_bwd",
            case=f"{name} bfloat16 B={B} S={S} H={H} G={G} K={K}"
                 + (f" window={window}" if window else "") + ("" if causal else " non-causal"),
            route="kernel", rel_l2_dq_dk_dv=errs, tol=FLASH_BWD_TOL, same_bits=same, ok=ok,
            ms=timer.ms(kernel), plain_ms=timer.ms(plain, iters=5, warmup=1),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
        ))
        torch.cuda.empty_cache()
    return out


def ssd_cases(torch, ops, ref, timer, dev):
    cases = [
        # name, B, S, H, P, N, chunk, dtype of x/B/C, dtype of y
        ("prefill", 1, 512, 32, 64, 128, 128, "bfloat16", "float32"),  # the model's call
        ("prefill", 1, 512, 32, 64, 128, 128, "bfloat16", "bfloat16"),
        ("tail", 1, 200, 32, 64, 128, 128, "bfloat16", "float32"),
        ("batch", 2, 512, 32, 64, 128, 128, "bfloat16", "float32"),
        ("f32", 1, 512, 32, 64, 128, 128, "float32", "float32"),
        ("continuation", 1, 512, 32, 64, 128, 128, "bfloat16", "float32"),
        # tests/test_kernels_ssd.py's sweep, then the reduced config's sizes
        ("sweep", 1, 128, 2, 64, 128, 128, "float32", "float32"),
        ("sweep", 2, 256, 4, 64, 128, 128, "float32", "float32"),
        ("sweep", 1, 256, 2, 32, 64, 64, "float32", "float32"),
        ("sweep", 2, 96, 2, 64, 128, 32, "float32", "float32"),
        ("sweep", 1, 200, 3, 16, 32, 64, "float32", "float32"),
        ("reduced", 1, 12, 8, 16, 16, 16, "float32", "float32"),
        ("train", 8, 512, 32, 64, 128, 128, "bfloat16", "float32"),  # mamba2-370m's step
        ("train_4k", 8, 4096, 32, 64, 128, 128, "bfloat16", "float32"),  # phase 11's train cell
        # jamba-1.5-large-398b's Mamba layers: 256 heads of 64, N 128, at a
        # prefill of 4 x 512
        ("jamba", 4, 512, 256, 64, 128, 128, "bfloat16", "float32"),
    ]
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for name, B, S, H, P, N, Q, dtype, ydtype in cases:
        tdt, ydt = getattr(torch, dtype), getattr(torch, ydtype)
        x = torch.randn(B, S, H, P, generator=gen, device=dev).to(tdt)
        dt, A = ssd_dt_A(torch, (B, S, H), gen, dev)
        Bm = torch.randn(B, S, N, generator=gen, device=dev).to(tdt)
        Cm = torch.randn(B, S, N, generator=gen, device=dev).to(tdt)
        y_want, s_want = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, Q)
        _, s_seq = ref.ssd_scan_ref(x, dt, A, Bm, Cm)
        init, lo = None, 0
        if name == "continuation":  # the first half's state into the second half
            lo = S // 2
            _, init = ops.ssd_scan(x[:, :lo], dt[:, :lo], A, Bm[:, :lo], Cm[:, :lo], Q)
            x, dt, Bm, Cm = (t[:, lo:].contiguous() for t in (x, dt, Bm, Cm))
            y_want = y_want[:, lo:]

        def kernel():
            return ops.ssd_scan(x, dt, A, Bm, Cm, Q, init_state=init, out_dtype=ydt)

        route = ops._ssd_route(tdt, P, N, Q, ops._ssd_aligned(x, Bm, Cm))
        before = ops.SSD_ROUTES[route]
        y, s = kernel()
        y2, s2 = kernel()
        torch.cuda.synchronize()
        assert ops.SSD_ROUTES[route] == before + 2, (name, route)
        tol = 2e-4 if ydtype == "float32" else 5e-2
        err = max((y.float() - y_want).abs().max().item(), (s - s_want).abs().max().item())
        ok = (bool(torch.isfinite(y).all()) and y.dtype == ydt
              and torch.equal(y, y2) and torch.equal(s, s2)  # the same bits every call
              and torch.allclose(y.float(), y_want, atol=tol, rtol=tol)
              and torch.allclose(s, s_want, atol=2e-4, rtol=2e-4)
              and torch.allclose(s, s_seq, atol=2e-4, rtol=2e-4))
        b_ms, b_by = ssd_bound(torch, x, Bm, Q, init, ydt)
        out.append(dict(
            kernel="ssd_scan",
            case=f"{name} {dtype} B={B} S={S - lo} H={H} P={P} N={N} chunk={Q} y={ydtype}"
                 + (" init_state" if init is not None else ""),
            route=route, max_abs_err=err, tol=tol, ok=ok,
            ms=timer.ms(kernel),
            plain_ms=timer.ms(lambda: ref.ssd_chunked_ref(x, dt, A, Bm, Cm, Q, init)),
            library_ms=None,  # no single PyTorch call computes the SSD scan
            bound_ms=b_ms, bound_by=b_by,
        ))
    return out


# --------------------------------------------------------------------------
# phases 4-7
# --------------------------------------------------------------------------


def serve(torch, np, cfg, params, ops, lengths, per_pass, routes):
    """Serve len(lengths) requests of 16 new tokens through ServeEngine at
    batch 4, with the launch counters set to 0 just before and read just
    after.  ``per_pass[kernel] = (per prefill, per decode step)``: the
    launches each forward pass must make; ``routes[kernel][kind]``: the
    route all of a prefill's or decode step's launches of that kernel must
    take.  Returns the run's launches (``_launch_counts``)."""
    from repro_torch.serve.engine import Request, ServeEngine

    by_route = {"flash_attention": ops.FLASH_ROUTES, "ssd_scan": ops.SSD_ROUTES}
    engine = ServeEngine(cfg, params, max_len=512, batch_size=4)
    finite = []
    to_host = engine._logits_to_host

    def checked(logits):
        arr = to_host(logits)
        finite.append(arr.shape[-1] == cfg.padded_vocab and bool(np.isfinite(arr).all()))
        return arr

    model = engine.model
    try:
        engine._logits_to_host = checked
        engine.generate([Request(99, [1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=2)])  # warm-up

        passes = []  # (kind, launches of that pass, its launches by route)

        def snapshot():
            return dict(ops.LAUNCHES), {k: dict(v) for k, v in by_route.items()}

        def counted(kind, fn):
            def call(*args, **kwargs):
                before, before_r = snapshot()
                out = fn(*args, **kwargs)
                after, after_r = snapshot()
                passes.append((kind, {k: after[k] - before[k] for k in before},
                               {k: {r: after_r[k][r] - before_r[k][r] for r in after_r[k]}
                                for k in after_r}))
                return out
            return call

        model.prefill = counted("prefill", model.prefill)
        model.decode_step = counted("decode", model.decode_step)

        rng = np.random.default_rng(0)
        reqs = [
            Request(i, rng.integers(0, cfg.vocab_size, n).tolist(), max_new_tokens=16)
            for i, n in enumerate(lengths)
        ]
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        route_counts = {k: dict(v) for k, v in by_route.items()}
        run_counts = _launch_counts(ops)

        n_prefill = len(engine.call_seconds["prefill"])
        n_decode = len(engine.call_seconds["decode"])
        assert all(r.done and len(r.generated) == 16 for r in reqs), "a request did not finish"
        assert all(finite), "non-finite logits"
        assert len(passes) == n_prefill + n_decode, (len(passes), n_prefill, n_decode)
        for kind, counts, pass_routes in passes:
            want = {k: v[0 if kind == "prefill" else 1] for k, v in per_pass.items()}
            assert counts == want, (kind, counts, want)
            for kernel, got in pass_routes.items():
                want_routes = {r: 0 for r in got}
                if kernel in routes:
                    want_routes[routes[kernel][kind]] = want[kernel]
                assert got == want_routes, (kind, kernel, got, want_routes)
        pre = sorted(engine.call_seconds["prefill"])
        dec = sorted(engine.call_seconds["decode"])
        n_tok = sum(len(r.generated) for r in reqs)
        log(f"serve {cfg.name}: {len(reqs)} requests, prompts {lengths}, {n_tok} tokens in "
            f"{wall:.4f} s = {n_tok / wall:.2f} tokens/s; {n_prefill} prefills + {n_decode} decode steps")
        log(f"serve {cfg.name}: prefill ms median {pre[len(pre) // 2] * 1e3:.3f} "
            f"(min {pre[0] * 1e3:.3f}, max {pre[-1] * 1e3:.3f}); decode-step ms median "
            f"{dec[len(dec) // 2] * 1e3:.3f} (min {dec[0] * 1e3:.3f}, max {dec[-1] * 1e3:.3f}); "
            f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"serve {cfg.name}: launches {launches} over {n_prefill} prefills + {n_decode} decode "
            f"steps; per pass (prefill, decode) {per_pass}; by route {route_counts}")
        return run_counts
    finally:  # the wrappers point back at engine and model: unwrap, so
        # nothing holds the weights once the caller drops them
        for obj, name in ((engine, "_logits_to_host"), (model, "prefill"),
                          (model, "decode_step")):
            vars(obj).pop(name, None)


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def prefill_decode_consistency(torch, np, cfg, params, on_call=lambda kind, row: None):
    """prefill(p[:n+1]) against prefill(p[:n]) + decode_step(p[n], pos=n),
    two rows at different depths decoded in one batch with per-row pos.
    ``on_call(kind, row)`` is called before each model call: ("full", row),
    ("split", row), then ("decode", None).  Returns the two rows' errors."""
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine

    # bf16 keeps 8 significant bits; the two paths round at different places
    # (other matmul shapes, so other cuBLAS kernels and sum orders, over 30
    # layers), so logits may drift by a few tenths of a percent per layer.
    # A wrong slot, position or mask moves the last token's attention over a
    # different context, which the control below measures.
    tol = 5e-2
    model = Model(cfg)
    dev = model.device
    rng = np.random.default_rng(1)
    ns = CONSISTENCY_PROMPTS
    prompts = [rng.integers(0, cfg.vocab_size, n + 1).tolist() for n in ns]
    cache = model.init_cache(2, 512)
    full = []
    for row, (p, n) in enumerate(zip(prompts, ns)):
        tok = torch.tensor([p], dtype=torch.int32, device=dev)
        on_call("full", row)
        full.append(model.prefill(params, {"tokens": tok})[0][0, 0])
        on_call("split", row)
        _, rc = model.prefill(params, {"tokens": tok[:, :n]}, model.init_cache(1, 512))
        ServeEngine.insert_row(cache, rc, row)
    last = torch.tensor([[p[n]] for p, n in zip(prompts, ns)], dtype=torch.int32, device=dev)
    on_call("decode", None)
    dec, _ = model.decode_step(params, cache, last, torch.tensor(ns, dtype=torch.int32, device=dev))
    errs = [rel_err(dec[i, 0], full[i]) for i in range(2)]
    control = rel_err(dec[1, 0], full[0])  # another row's context: what a fault looks like
    log(f"consistency {cfg.name}: rel L2 err of decode vs prefill logits {errs} (tol {tol}); "
        f"control (row 1's decode vs row 0's prefill) {control:.4f}")
    assert all(torch.isfinite(d).all() for d in full) and bool(torch.isfinite(dec).all())
    return errs, tol


CONSISTENCY_PROMPTS = [37, 120]  # the split prefills' lengths; one more token decoded


def dense_consistency(torch, np, cfg, params):
    errs, tol = prefill_decode_consistency(torch, np, cfg, params)
    assert max(errs) <= tol, errs


class PinnedRouting:
    """While installed and while ``pins`` holds choices, makes each MoE
    routing call (``moe._scores``) choose the next pinned experts: top-k
    taken from the call's own scores at those experts, renormalised as the
    router does.  ``differ`` counts the tokens whose own top-k was another
    set of experts."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.pins, self.differ = moe, [], 0

    def __enter__(self):
        self.scores = scores = self.moe._scores

        def pinned(router, cfg, xt):
            probs, top_p, top_i = scores(router, cfg, xt)
            if self.pins:
                own, top_i = top_i, self.pins.pop(0)
                self.differ += int((own.sort(-1).values != top_i.sort(-1).values).any(-1).sum())
                top_p = probs.gather(1, top_i)
                top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
            return probs, top_p, top_i

        self.moe._scores = pinned
        return self

    def __exit__(self, *exc):
        self.moe._scores = self.scores


# bf16 keeps 8 significant bits, so the full prefill and the split path's
# hidden states differ by parts in 2^8, and so do their router scores (on
# the H100 moonshot-v1-16b-a3b's differ by up to 1.2 % at layer 1).  Where
# a token's dropped and swapped-in experts lie within NEAR_TIE of each
# other (relative to the dropped one's full-prefill score), rounding may
# break the tie; a routing fault swaps experts whatever their scores.
NEAR_TIE = 2**-6
FLIP_SHARE = 0.01  # at most this share of the routing choices may differ
FLIP_TOL = 0.2  # an unpinned row with near-tie flips; a wrong context reads ~1.5


def moe_consistency(torch, np, cfg, params, near_tie_flips=False):
    """prefill_decode_consistency with capacity raised (no pair drops), run
    twice.  First as it is, every routing call recorded: bf16 rounds the
    full prefill and the split path apart, so a token near a tie between
    two experts may choose another in one of them.  These flips are
    counted (at most FLIP_SHARE of the choices) and the first few logged
    with their layer, token and both paths' scores.  Then with every
    routing call of the split path pinned to the experts the full prefill
    chose for the same token: with the routing equal, what is left to
    differ is the cache, the positions and the masks, and this run must
    hold the bound.  The first run must hold it too, except, where
    ``near_tie_flips``, a row whose flips at the first layer where it has
    any are all near-ties (NEAR_TIE): such a row is held to FLIP_TOL."""
    import dataclasses

    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))  # C >= T K
    L, ns = moe_layers(cfg), CONSISTENCY_PROMPTS
    with RouteLog() as rl:
        plain, tol = prefill_decode_consistency(torch, np, cfg, params)
    calls = [rl.records[i : i + L] for i in range(0, len(rl.records), L)]  # a model call each
    full, split, dec = calls[0::2][:2], calls[1::2][:2], calls[4]
    chosen = []  # (layer, row, token, full's (probs, top_i), the other path's)
    for row, n in enumerate(ns):
        for layer in range(L):
            f, o, d = full[row][layer], split[row][layer], dec[layer]
            chosen += [(layer, row, t, (f.probs[t], f.top_i[t]), (o.probs[t], o.top_i[t]))
                       for t in range(n)]
            chosen.append((layer, row, n, (f.probs[n], f.top_i[n]), (d.probs[row], d.top_i[row])))
    flips = [c for c in chosen if not torch.equal(c[3][1].sort().values, c[4][1].sort().values)]
    log(f"consistency {cfg.name}: {len(flips)} of {len(chosen)} (layer, token) routing choices "
        f"differ between the full prefill and prefill + decode")
    for layer, row, t, (fp, fi), (op, oi) in flips[:3]:
        top = torch.topk(fp, cfg.top_k + 1).indices
        log(f"consistency {cfg.name}: flip at MoE layer {layer}, row {row}, token {t}: experts "
            f"{sorted(fi.tolist())} (full prefill) against {sorted(oi.tolist())}; scores at "
            f"{top.tolist()}: {[round(float(x), 7) for x in fp[top]]} against "
            f"{[round(float(x), 7) for x in op[top]]}")

    def pin(kind, row):
        if kind == "split":
            pr.pins = [full[row][layer].top_i[: ns[row]] for layer in range(L)]
        elif kind == "decode":
            pr.pins = [torch.stack([full[r][layer].top_i[n] for r, n in enumerate(ns)])
                       for layer in range(L)]

    with PinnedRouting() as pr:
        pinned, _ = prefill_decode_consistency(torch, np, cfg, params, on_call=pin)
    log(f"consistency {cfg.name}: routing pinned to the full prefill's choices: rel L2 err "
        f"{pinned} (tol {tol}); as it is {plain}, with {len(flips)} flips")
    assert max(pinned) <= tol, pinned
    assert len(flips) <= FLIP_SHARE * len(chosen), (len(flips), len(chosen))
    for row, err in enumerate(plain):
        if err <= tol:
            continue
        assert near_tie_flips, (row, plain)
        mine = [c for c in flips if c[1] == row]
        assert mine, f"row {row}: error {err} above {tol} with no routing flip"
        first = [c for c in mine if c[0] == min(m[0] for m in mine)]
        for layer, _, t, (fp, fi), (_, oi) in first:
            dropped = sorted(set(fi.tolist()) - set(oi.tolist()))
            swapped = sorted(set(oi.tolist()) - set(fi.tolist()))
            top = float(fp[dropped].max())
            gap = (top - float(fp[swapped].min())) / top
            log(f"consistency {cfg.name}: row {row}'s first flip, MoE layer {layer}, token {t}: "
                f"experts {dropped} dropped for {swapped}, full-prefill scores "
                f"{[float(fp[e]) for e in dropped]} against {[float(fp[e]) for e in swapped]}, "
                f"relative gap {gap:.5f} (near tie below {NEAR_TIE})")
            assert gap < NEAR_TIE, (row, layer, t, gap)
        assert err <= FLIP_TOL, (row, err, FLIP_TOL)


def small_model_against_cpu(torch, np, ops, arch="deepseek-7b"):
    """Reduced ``arch`` (its own head_dim 16, fp32) on the card through
    the kernels against the same weights on the CPU through the plain
    versions."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import Model

    tol = 1e-4
    cfg = reduced_config(arch)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(3))
    p_gpu = _tree_to(p_cpu, gpu.device)
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    )

    def run(model, params):
        dev = model.device
        cache = model.init_cache(3, 32)
        outs = [model.prefill(params, {"tokens": toks[:, :12].to(dev)}, cache)[0].cpu()]
        for i in range(4):  # rows at different depths: per-row positions
            pos = torch.tensor([12 + i, 13 + i, 14 + i], dtype=torch.int32, device=dev)
            tok = toks[:, 12 + i : 13 + i].to(dev)
            outs.append(model.decode_step(params, cache, tok, pos)[0].cpu())
        return outs

    before = _launch_counts(ops)
    out_gpu = run(gpu, p_gpu)
    shapes = _flash_shapes(_diff(_launch_counts(ops), before))
    # fp32: the prefill takes the FMA route, the decode steps the decode route
    want = {"decode K=16 causal": 4 * cfg.n_layers, "fma K=16 causal": cfg.n_layers}
    assert shapes == want, (shapes, want)
    worst = max((a - b).abs().max().item() for a, b in zip(out_gpu, run(cpu, p_cpu)))
    log(f"small model: reduced {cfg.name} (head_dim {cfg.head_dim}), cuda kernels vs cpu plain "
        f"path, prefill + 4 decode steps, max abs logit err {worst:.3e} (tol {tol}); flash by "
        f"shape {shapes}")
    assert worst <= tol, worst


def ssm_prefill_decode_consistency(torch, np, cfg, params):
    """prefill(p[:S]) against prefill(p[:S-4]) + 4 decode steps, two rows
    of different lengths in one batch.  The decode steps run the plain
    recurrence, so this holds the kernel's final state against it.  Run
    in bf16 (tol 5e-2, as in prefill_decode_consistency) and again with the
    same weights in fp32, where rounding drift over 48 layers stays far
    below 1e-3: a gap there would be a fault, not drift."""
    import dataclasses

    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.tree import tree_map

    rng = np.random.default_rng(6)
    ns = [41, 204]  # prefills of 37 and 200 tokens: a tail chunk each
    toks = [rng.integers(0, cfg.vocab_size, n).tolist() for n in ns]
    for dtype, tol in (("bfloat16", 5e-2), ("float32", 1e-3)):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = params if dtype == cfg.dtype else tree_map(lambda t: t.float(), params)
        model = Model(c)
        dev = model.device
        prompts = [torch.tensor([t], dtype=torch.int32, device=dev) for t in toks]
        full = [model.prefill(p, {"tokens": t})[0][0, 0] for t in prompts]
        cache = model.init_cache(2, 512)
        for row, (t, n) in enumerate(zip(prompts, ns)):
            _, rc = model.prefill(p, {"tokens": t[:, : n - 4]}, model.init_cache(1, 512))
            ServeEngine.insert_row(cache, rc, row)
        for i in range(4):
            tok = torch.cat([t[:, n - 4 + i : n - 3 + i] for t, n in zip(prompts, ns)])
            pos = torch.tensor([n - 4 + i for n in ns], dtype=torch.int32, device=dev)
            dec, _ = model.decode_step(p, cache, tok, pos)
        errs = [rel_err(dec[i, 0], full[i]) for i in range(2)]
        control = rel_err(dec[1, 0], full[0])
        log(f"consistency {cfg.name} {dtype}: rel L2 err of prefill(S-4) + 4 decode steps vs "
            f"prefill(S) logits, S = {ns}: {errs} (tol {tol}); control (row 1's decode vs "
            f"row 0's prefill) {control:.4f}")
        assert all(torch.isfinite(d).all() for d in full) and bool(torch.isfinite(dec).all())
        assert max(errs) <= tol, errs
        del p, cache


def small_ssm_against_cpu(torch, np, ops):
    """Reduced mamba2-370m (fp32) on the card through the kernels against
    the same weights on the CPU through the plain versions: prompts of 1,
    2 and 12 tokens prefilled into three rows, then 4 decode steps."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine

    tol = 1e-4
    cfg = reduced_config("mamba2-370m")
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(7))
    p_gpu = _tree_to(p_cpu, gpu.device)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (3, 16)).astype(np.int32)
    lengths = [1, 2, 12]

    def run(model, params):
        dev = model.device
        cache = model.init_cache(3, 32)
        outs = []
        for row, n in enumerate(lengths):
            tok = torch.from_numpy(toks[row : row + 1, :n]).to(dev)
            logits, rc = model.prefill(params, {"tokens": tok}, model.init_cache(1, 32))
            ServeEngine.insert_row(cache, rc, row)
            outs.append(logits.cpu())
        for i in range(4):
            tok = torch.from_numpy(np.stack([toks[r, n + i : n + i + 1] for r, n in enumerate(lengths)]))
            pos = torch.tensor([n + i for n in lengths], dtype=torch.int32, device=dev)
            outs.append(model.decode_step(params, cache, tok.to(dev), pos)[0].cpu())
        return outs

    n = ops.LAUNCHES["ssd_scan"]
    worst = max(
        (a - b).abs().max().item() for a, b in zip(run(gpu, p_gpu), run(cpu, p_cpu))
    )
    assert ops.LAUNCHES["ssd_scan"] - n == len(lengths) * cfg.n_layers, "the SSD kernel did not run"
    log(f"small ssm model: cuda kernels vs cpu plain path, prefills of {lengths} + 4 decode "
        f"steps, max abs logit err {worst:.3e} (tol {tol})")
    assert worst <= tol, worst


def _tree_to(tree, device):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.to(device), tree)


def profile_decode(torch, cfg, params, batch: int = 4, steps: int = 5, bounds=None):
    """Device busy share and time by kernel over decode steps at the
    serving batch, from torch.profiler.  ``bounds`` (MoE): (bytes of the
    expert weights, bytes of all weights a step reads): the expert
    products' device time (the kernels under ``aten::bmm``, which only
    the MoE layer calls) and the step's are set against them."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import Model

    model = Model(cfg)
    dev = model.device
    cache = model.init_cache(batch, 512)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=dev)
    pos = [torch.full((batch,), 100 + i, dtype=torch.int32, device=dev) for i in range(steps + 1)]
    model.decode_step(params, cache, tok, pos[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            model.decode_step(params, cache, tok, pos[i + 1])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        log(f"profile {cfg.name}: the profiler recorded no device time; busy share not measured")
        return
    n_launch = sum(e.count for e in kernels)
    log(f"profile {cfg.name}: decode at batch {batch}, {steps} steps: wall {wall_us / steps / 1e3:.3f} ms/step "
        f"(profiled), device busy {busy_us / steps / 1e3:.3f} ms/step = "
        f"{busy_us / wall_us:.4f} of wall, {n_launch / steps:.0f} kernels/step")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in ranked[:8] + [e for e in ranked[8:] if "flash" in e.key]:
        log(f"profile {cfg.name}:   {e.self_device_time_total / steps / 1e3:8.4f} ms/step "
            f"{e.count // steps:5d}/step  {e.key[:90]}")
    if bounds is not None:
        expert_bytes, step_bytes = bounds
        bmm = [e for e in prof.key_averages() if e.key == "aten::bmm"]
        bmm_ms = sum(e.device_time_total for e in bmm) / steps / 1e3
        t_expert, t_step = (bound(b, 0, "bfloat16")[0] for b in (expert_bytes, step_bytes))
        log(f"profile {cfg.name}: expert products (aten::bmm, {sum(e.count for e in bmm) // steps}/step) "
            + (f"{bmm_ms:.4f} ms/step of device time" if bmm_ms else "device time not measured")
            + f", byte bound {t_expert:.4f} ms ({expert_bytes / 1e9:.3f} GB of expert weights); "
            f"device busy {busy_us / steps / 1e3:.4f} ms/step against the step's byte bound "
            f"{t_step:.4f} ms ({step_bytes / 1e9:.3f} GB of weights)")


def profile_prefill(torch, np, cfg, params, S: int = 300):
    """Device time by kernel of one prefill of an S-token prompt (the
    mamba2-370m serve run's longest), from torch.profiler, and the SSD
    scan's share of it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import Model

    model = Model(cfg)
    dev = model.device
    tok = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab_size, (1, S)).astype(np.int32)).to(dev)
    model.prefill(params, {"tokens": tok}, model.init_cache(1, 512))  # warm-up
    cache = model.init_cache(1, 512)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": tok}, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if not busy_us:
        log(f"profile prefill {cfg.name}: the profiler recorded no device time; not measured")
        return
    ssd_us = sum(e.self_device_time_total for e in kernels if "ssd" in e.key)
    log(f"profile prefill {cfg.name}: S={S}, wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_us / 1e3:.4f} ms = {busy_us / 1e3 / wall_ms:.4f} of wall, "
        f"{sum(e.count for e in kernels)} kernels; SSD scan {ssd_us / 1e3:.4f} ms = "
        f"{ssd_us / busy_us:.4f} of device time")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in ranked[:10] + [e for e in ranked[10:] if "ssd" in e.key]:
        log(f"profile prefill {cfg.name}:   {e.self_device_time_total / 1e3:8.4f} ms "
            f"{e.count:5d}x  {e.key[:90]}")


CALIBRATE_BATCHES = (1, 8, 32, 128)
CALIBRATE_STEPS = 24


def calibrate_phase(cfg, params, card):
    """The decode-step latency curve of ``cfg``'s engine on the card, logged
    and returned (phase 12 runs the scheduler on it): the reference's own
    recipe (benchmarks/README.md, "Refreshing the serve baseline"),
    ``calibrate(ServeEngine(cfg, params, max_len=64))`` at its default
    batch sizes and steps."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.latency import calibrate

    engine = ServeEngine(cfg, params, max_len=64)
    t0 = time.perf_counter()
    curve = calibrate(engine, batch_sizes=CALIBRATE_BATCHES, steps=CALIBRATE_STEPS)
    log(f"calibrate: {card}; {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, head_dim "
        f"{cfg.head_dim}, {cfg.dtype}, max_len 64, batch sizes {CALIBRATE_BATCHES}, "
        f"{CALIBRATE_STEPS} steps each: base {curve.base!r} s, per_req {curve.per_req!r} s "
        f"({time.perf_counter() - t0:.1f} s); step_time(b) ms: "
        + ", ".join(f"{b}: {curve.step_time(b) * 1e3:.3f}" for b in CALIBRATE_BATCHES))
    return curve


def reduced_curve_phase(torch, ops, dev, card):
    """The curve the reference's ``DEFAULT_SERVE_MODEL`` was measured on,
    measured on the card: reduced deepseek-7b (float32, head_dim 16,
    weights from seed 0) through ``calibrate_phase``, with the launch
    counters set to 0 just before and read just after.  Every decode step
    (a warm-up and the timed steps at each batch size) launches one
    ``decode K=16 causal`` attention kernel a layer and nothing else of
    flash.  Returns the run's launches and the curve."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import Model

    cfg = reduced_config("deepseek-7b")
    params = init_params(torch, Model, cfg, dev)
    ops.reset_launches()
    curve = calibrate_phase(cfg, params, card)
    counts = _launch_counts(ops)
    steps, L = len(CALIBRATE_BATCHES) * (CALIBRATE_STEPS + 1), cfg.n_layers
    shapes = _flash_shapes(counts)
    log(f"calibrate: reduced {cfg.name}: {steps} decode steps, launches {dict(ops.LAUNCHES)}, "
        f"flash by shape {shapes}")
    assert shapes == {"decode K=16 causal": steps * L}, shapes
    assert dict(ops.LAUNCHES) == {"rmsnorm": steps * (2 * L + 1), "flash_attention": steps * L,
                                  "ssd_scan": 0}, ops.LAUNCHES
    return counts, curve


# --------------------------------------------------------------------------
# phase 8: MoE
# --------------------------------------------------------------------------


class RouteLog:
    """While installed, records the ``moe.Routing`` of each MoE routing
    call of the model: its tensors are kept as they are, so the recording
    adds no launch and no wait to the run."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe, self.records = moe, []

    def __enter__(self):
        self.route = route = self.moe.route

        def recorded(router, cfg, xt, *args):
            r = route(router, cfg, xt, *args)
            self.records.append(r)
            return r

        self.moe.route = recorded
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def same_routing(torch, step, got, want):
    """Whether two runs' routing calls (``RouteLog.records``, the card's
    and the CPU's) chose the same experts and dropped the same pairs; the
    first call that differs is logged, with ``step`` (a train step, or
    "serve"), its first differing token and that token's router scores on
    both."""
    if len(got) != len(want):
        log(f"routing: step {step}: {len(got)} routing calls against {len(want)}")
        return False
    for i, (a, b) in enumerate(zip(got, want)):
        ti, keep = a.top_i.cpu(), a.keep.cpu()
        if a.capacity == b.capacity and torch.equal(ti, b.top_i) and torch.equal(keep, b.keep):
            continue
        tok = int(((ti != b.top_i).any(-1) | (keep != b.keep).any(-1)).nonzero()[0])
        log(f"routing: step {step} call {i} differs first at token {tok}: experts "
            f"{ti[tok].tolist()} kept {keep[tok].tolist()} (card) against {b.top_i[tok].tolist()} "
            f"kept {b.keep[tok].tolist()} (cpu); scores {a.probs[tok].cpu().tolist()} against "
            f"{b.probs[tok].tolist()}")
        return False
    return True


def moe_weight_bytes(cfg, params, batch: int):
    """(bytes of the expert weights, bytes of all weights a decode step of
    ``batch`` rows reads: every leaf once, but of the token table only the
    rows it looks up)."""
    from repro_torch.tree import leaves_with_paths

    expert = step = 0
    for key, t in leaves_with_paths(params):
        size = t.numel() * t.element_size()
        if "tokens" in key:
            size = batch * t.shape[1] * t.element_size()
        step += size
        if "moe/" in key and any(w in key for w in ("w_up", "w_gate", "w_down")):
            expert += size
    return expert, step


def serve_moe(torch, np, cfg, params, ops, lengths, per_pass=None, routes=None):
    """serve() with every routing call recorded: each prefill's dropped
    (token, k) pairs, MoE layer by MoE layer.  ``per_pass`` and ``routes``
    default to a MoE transformer's (every layer attention and MoE)."""
    n = moe_layers(cfg)
    with RouteLog() as rl:
        counts = serve(
            torch, np, cfg, params, ops, lengths=lengths,
            per_pass=per_pass or {"rmsnorm": (norms_a_layer(cfg) * n + 1,) * 2,
                                  "flash_attention": (n, n), "ssd_scan": (0, 0)},
            routes=routes or {"flash_attention": {"prefill": "mma_prefill", "decode": "decode"}},
        )
    # one pass is n routing calls of T tokens each
    passes = [rl.records[i : i + n] for i in range(0, len(rl.records), n)]
    tokens = [{r.top_i.shape[0] for r in ps} for ps in passes]
    assert len(rl.records) % n == 0 and all(len(t) == 1 for t in tokens), tokens
    tokens = [t.pop() for t in tokens]
    # the warm-up request (8 tokens, 1 decode step of 1 row) comes first;
    # then a prefill has T = its prompt's length, a decode step T = 4 rows
    prefills = [ps for ps, T in zip(passes[2:], tokens[2:]) if T != 4]
    assert [T for T in tokens[2:] if T != 4] == lengths, tokens
    for T, ps in zip(lengths, prefills):
        dropped = [int((~r.keep).sum()) for r in ps]
        used = sorted(int((r.load > 0).sum()) for r in ps)
        log(f"serve {cfg.name}: prefill T={T}: capacity {ps[0].capacity} a expert, {T * cfg.top_k} "
            f"(token, k) pairs a layer; dropped {sum(dropped)} over {n} MoE layers "
            f"({sum(dropped) / (n * T * cfg.top_k):.4f}), by layer {dropped}; experts chosen "
            f"by any pair a layer: min {used[0]}, median {used[n // 2]}, max {used[-1]} of "
            f"{cfg.n_experts}; largest load {max(int(r.load.max()) for r in ps)} pairs")
    decode_dropped = sum(int((~r.keep).sum()) for ps, T in zip(passes[2:], tokens[2:]) if T == 4
                         for r in ps)
    log(f"serve {cfg.name}: decode steps dropped {decode_dropped} pairs (capacity 8, 4 rows)")
    assert decode_dropped == 0, decode_dropped
    return counts


def small_moe_against_cpu(torch, np, ops, arch):
    """Reduced ``arch`` (head_dim 16, fp32) on the card through the kernels
    against the same weights on the CPU through the plain versions: a
    prefill of 3 x 12 tokens and 4 decode steps at per-row positions, at
    capacity_factor 0.5, where the prefill drops pairs.  The logits within
    1e-4, and every routing call picks the same experts and drops the same
    pairs on both."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import Model

    tol = 1e-4
    cfg = dataclasses.replace(reduced_config(arch), capacity_factor=0.5)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(12))
    p_gpu = _tree_to(p_cpu, gpu.device)
    toks = torch.from_numpy(
        np.random.default_rng(13).integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    )

    def run(model, params):
        dev = model.device
        cache = model.init_cache(3, 32)
        with RouteLog() as rl:
            outs = [model.prefill(params, {"tokens": toks[:, :12].to(dev)}, cache)[0].cpu()]
            for i in range(4):
                pos = torch.tensor([12 + i, 13 + i, 14 + i], dtype=torch.int32, device=dev)
                outs.append(model.decode_step(params, cache, toks[:, 12 + i : 13 + i].to(dev), pos)[0].cpu())
        return outs, rl.records

    n0 = _launch_counts(ops)
    out_gpu, r_gpu = run(gpu, p_gpu)
    launches = {k: v for k, v in _diff(_launch_counts(ops), n0).items() if v}
    out_cpu, r_cpu = run(cpu, p_cpu)
    worst = max((a - b).abs().max().item() for a, b in zip(out_gpu, out_cpu))
    same = len(r_cpu) == 5 * cfg.n_layers and same_routing(torch, "serve", r_gpu, r_cpu)
    dropped = sum(int((~r.keep).sum()) for r in r_gpu)
    log(f"small moe model: reduced {arch}, cuda kernels vs cpu plain path, prefill 3 x 12 + 4 "
        f"decode steps, capacity_factor 0.5: max abs logit err {worst:.3e} (tol {tol}); the same "
        f"experts and dropped pairs in all {len(r_gpu)} routing calls: {same}; {dropped} pairs "
        f"dropped (prefill capacity {r_gpu[0].capacity}); launches {launches}")
    L = cfg.n_layers
    assert launches == {"rmsnorm": 5 * (norms_a_layer(cfg) * L + 1), "flash_attention": 5 * L,
                        "flash/fma": L, "flash/fma K=16 causal": L,
                        "flash/decode": 4 * L, "flash/decode K=16 causal": 4 * L}, launches
    assert same and dropped > 0 and worst <= tol, (same, dropped, worst)


SERVE_PROMPTS = [200, 5, 83, 161, 44, 122]  # the serve runs' prompt lengths
# the paths added last (moonshot-v1-16b-a3b, qwen3-32b, granite-34b) serve one
# batch of 4 and profile 2 decode steps, to keep the whole run near 560 s
NEW_PATH_PROMPTS = SERVE_PROMPTS[:4]
NEW_PATH_PROFILED_STEPS = 2


def moe_phase(torch, np, ops, dev, card):
    """Main path 5 and its checks, on qwen3-moe-30b-a3b, then on
    moonshot-v1-16b-a3b (the first's weights freed first).  Returns the
    launches of each serve run and qwen3-moe-30b-a3b's calibrated curve."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    counts = {}
    for arch in ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"):
        first = arch == "qwen3-moe-30b-a3b"
        cfg = get_config(arch)
        params = init_params(torch, Model, cfg, dev)
        log_kv_cache(cfg)
        counts[arch] = serve_moe(torch, np, cfg, params, ops,
                                 lengths=SERVE_PROMPTS if first else NEW_PATH_PROMPTS)
        # moonshot-v1-16b-a3b's decode token breaks a near tie at layer 1
        moe_consistency(torch, np, cfg, params, near_tie_flips=not first)
        small_moe_against_cpu(torch, np, ops, arch)
        profile_decode(torch, cfg, params, steps=5 if first else NEW_PATH_PROFILED_STEPS,
                       bounds=moe_weight_bytes(cfg, params, 4))
        if first:
            curve = calibrate_phase(cfg, params, card)
        del params
        torch.cuda.empty_cache()
    return counts, curve


def moe_layers(cfg) -> int:
    """The MoE layers of a model: its routing calls a forward pass."""
    return cfg.n_scan_blocks * sum(f == "moe" for _, f in cfg.layer_kinds())


def hybrid_layers(cfg):
    """(attention layers, Mamba layers, RMSNorm launches a forward pass) of
    a hybrid: every layer has ln1 and ln2 (dense or MoE ff), a Mamba layer
    adds its gated norm, and the final norm."""
    kinds, nb = cfg.layer_kinds(), cfg.n_scan_blocks
    n_attn = nb * sum(m == "attn" for m, _ in kinds)
    n_mamba = nb * sum(m == "mamba" for m, _ in kinds)
    return n_attn, n_mamba, 2 * cfg.n_layers + n_mamba + 1


def norms_a_layer(cfg) -> int:
    """RMSNorm launches a layer makes in a forward pass: ln1 and ln2, and
    the q- and k-norms of a qk-norm config."""
    return 4 if cfg.qk_norm else 2


def log_kv_cache(cfg) -> None:
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    log(f"init {cfg.name}: KV cache {kv / 1024:.0f} KiB a token, "
        f"{4 * 512 * kv / 2**20:.0f} MiB at batch 4 x 512")


# --------------------------------------------------------------------------
# phase 9: training
# --------------------------------------------------------------------------


def _launch_counts(ops):
    """Launches per kernel, per route (``flash/decode``, ``ssd/mma``) and
    per flash shape (``flash/decode K=128 causal``), as one flat dict."""
    out = dict(ops.LAUNCHES)
    out.update({f"flash/{r}": n for r, n in ops.FLASH_ROUTES.items()})
    out.update({f"flash/{k}": n for k, n in ops.FLASH_SHAPES.items()})
    out.update({f"ssd/{r}": n for r, n in ops.SSD_ROUTES.items()})
    return out


def _diff(after, before):
    return {k: after[k] - before.get(k, 0) for k in after}


def _flash_shapes(counts):
    """The flash launches of ``counts`` (``_launch_counts``) by shape,
    ``{"decode K=16 causal": n}``, those not launched left out."""
    return {k[len("flash/"):]: n for k, n in counts.items()
            if k.startswith("flash/") and " K=" in k and n}


def expected_first_loss(cfg) -> float:
    """The mean NLL of uniform random labels at init: ln(V) + s^2 / 2 over
    the padded vocab V, where s^2 = D std^2 is the variance of a logit (the
    final norm leaves each row of h at RMS 1, and the unembedding's entries
    are N(0, std^2)): 1 for deepseek-7b (std D^-0.5), 0.41 for mamba2-370m
    (tied, std 0.02)."""
    import math

    from repro_torch.models.layers import embedding_spec

    spec = embedding_spec(cfg)
    std = spec["tokens" if cfg.tie_embeddings else "unembed"][1]
    return math.log(cfg.padded_vocab) + cfg.d_model * std**2 / 2


def timed_step(torch, ops, step_fn, state, batch, records):
    """One train step; appends to ``records`` its host-clock wall time to
    a synchronised end, loss, grad norm and the launches it made."""
    before = _launch_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    records.append(dict(wall=wall, loss=float(metrics["loss"]), xent=float(metrics["xent"]),
                        aux=float(metrics["aux"]), grad_norm=float(metrics["grad_norm"]),
                        launches=_diff(_launch_counts(ops), before)))
    return state, metrics


def check_train_records(cfg, records, per_step, tokens_per_step, label):
    """Finite losses and grad norms, the step-0 cross-entropy (the loss
    less a MoE model's 0.01 aux) near its expected value, and the
    launches of every step as predicted."""
    import math

    want0 = expected_first_loss(cfg)
    ln_v = math.log(cfg.padded_vocab)
    for i, r in enumerate(records):
        log(f"{label}: step {i} loss {r['loss']!r} xent {r['xent']!r} aux {r['aux']!r} grad_norm "
            f"{r['grad_norm']!r} wall {r['wall'] * 1e3:.3f} ms = "
            f"{tokens_per_step / r['wall']:.1f} tokens/s; launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }")
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records), records
    xent0 = records[0]["xent"]
    log(f"{label}: step-0 cross-entropy {xent0!r}: ln(V) = {ln_v!r} (distance {xent0 - ln_v:+.4f}), "
        f"expected ln(V) + s^2/2 = {want0!r} (distance {xent0 - want0:+.4f}, tol 0.5)")
    assert abs(xent0 - want0) <= 0.5, (xent0, want0)
    for i, r in enumerate(records):
        got = {k: v for k, v in r["launches"].items() if v}
        assert got == per_step, (label, i, got, per_step)


def _kernel_kind(name: str) -> str:
    """A coarse class of a device kernel, from its name."""
    k = name.lower()
    if any(s in k for s in ("rmsnorm", "flash", "ssd")):
        return "hand-written"
    if any(s in k for s in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "gemm"
    if "reduce" in k:
        return "reduction"
    if "copy" in k:
        return "copy/cast"
    return "elementwise"


def profile_calls(torch, label, fn, calls: int = 1):
    """Wall ms a call (host clock, profiled), device busy ms a call, its
    share of the wall, kernels a call and the costliest kernels, from
    torch.profiler over ``calls`` calls of fn."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    if not busy_ms:
        log(f"profile {label}: the profiler recorded no device time; busy share not measured")
        return
    kinds = {}
    for e in kernels:
        ms, n = kinds.get(_kernel_kind(e.key), (0.0, 0))
        kinds[_kernel_kind(e.key)] = (ms + e.self_device_time_total / 1e3 / calls, n + e.count // calls)
    log(f"profile {label}: wall {wall_ms:.3f} ms a call (profiled), device busy {busy_ms:.4f} ms "
        f"= {busy_ms / wall_ms:.4f} of wall, {sum(e.count for e in kernels) // calls} kernels a call; "
        "by kind (ms, launches): "
        + ", ".join(f"{k} {ms:.4f} {n}" for k, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in ranked[:10] + [e for e in ranked[10:] if _kernel_kind(e.key) == "hand-written"]:
        log(f"profile {label}:   {e.self_device_time_total / 1e3 / calls:9.4f} ms "
            f"{e.count // calls:6d}x  {e.key[:110]}")


def profile_train_step(torch, model, opt_cfg, step_fn, state, batch, label):
    """One train step profiled (``profile_calls``); then one more step
    split into its two halves, loss_and_grads and adamw_update, each timed
    to a synchronised end."""
    from repro_torch.train.optimizer import adamw_update
    from repro_torch.train.train_step import loss_and_grads

    profile_calls(torch, label, lambda: step_fn(state, batch))
    t0 = time.perf_counter()
    _, _, grads = loss_and_grads(model, state.params, batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(opt_cfg, state.params, grads, state.opt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"profile {label}: an unprofiled step split: loss_and_grads {(t1 - t0) * 1e3:.3f} ms, "
        f"adamw_update {(t2 - t1) * 1e3:.3f} ms (host clock, synchronised)")


def train_cut(torch, ops, dev, arch, layers, steps: int = 3):
    """Main path 3: ``arch`` at full width, depth cut to ``layers`` (the
    reference's fp32 AdamW moments for every layer would not fit in 80 GB),
    bf16, batch 4 x seq 512 from DataLoader(seed=0), make_train_step on
    init_train_state; each step's routing calls recorded (a MoE model's
    dropped pairs a step).  The peak is logged against its reckoning:
    the state, the bf16 grads, about five fp32 temporaries of the largest
    leaf in the eager AdamW, and the logits' bf16, fp32 and grad copies.
    Returns its launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import n_params
    from repro_torch.train.data import DataLoader
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import leaves

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    label = f"train {arch}"
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    n_p = n_params(state.params)
    log(f"{label}: {cfg.n_layers} layers, {n_p} params, state {state_gb:.2f} GB (bf16 params, "
        f"fp32 m and v), init {time.perf_counter() - t0:.1f} s")
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=100)
    step_fn = make_train_step(model, opt_cfg)
    B, S = 4, 512
    loader = DataLoader(cfg, B, S, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in loader.next().items()}
               for _ in range(steps + 1)]
    L = cfg.n_layers
    records = []
    ops.reset_launches()
    with RouteLog() as rl:
        for batch in batches[:steps]:
            n0 = len(rl.records)
            state, _ = timed_step(torch, ops, step_fn, state, batch, records)
            calls = rl.records[n0:]  # the forward's L calls, then the recompute's
            if cfg.n_experts:
                drops = [int((~r.keep).sum()) for r in calls]
                log(f"{label}: step {len(records) - 1}: {len(calls)} routing calls of {B * S} "
                    f"tokens, capacity {calls[0].capacity}; dropped (token, k) pairs by layer "
                    f"{drops[:L]} of {B * S * cfg.top_k} a layer; aux {records[-1]['aux']!r}")
                assert len(calls) == 2 * L and drops[:L] == drops[L:][::-1], drops
    counts = _launch_counts(ops)
    launches, flash_routes = dict(ops.LAUNCHES), dict(ops.FLASH_ROUTES)
    # one backward a layer a step, each on the backward kernels
    assert ops.FLASH_BWD == {f"kernel K={cfg.head_dim} causal": L * steps}, ops.FLASH_BWD
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_train_records(cfg, records, {"rmsnorm": 2 * norms_a_layer(cfg) * L + 1,
                                       "flash_attention": 2 * L, "flash/mma_prefill": 2 * L,
                                       f"flash/mma_prefill K={cfg.head_dim} causal": 2 * L},
                        B * S, label)
    walls = sorted(r["wall"] for r in records[1:])
    largest = max(p.numel() for p in leaves(state.params))
    grads_gb, adamw_gb = 2 * n_p / 1e9, 5 * 4 * largest / 1e9
    logits_gb = B * S * cfg.padded_vocab * (2 + 4 + 4) / 1e9
    log(f"{label}: {steps} steps at batch {B} x seq {S}; step wall after the first "
        f"{[round(w * 1e3, 3) for w in walls]} ms, {B * S / walls[0]:.1f} tokens/s at the best; "
        f"peak memory {peak:.2f} GB against the reckoning {state_gb + grads_gb + adamw_gb + logits_gb:.2f}"
        f" GB = state {state_gb:.2f} + bf16 grads {grads_gb:.2f} + AdamW's 5 fp32 temporaries of "
        f"the largest leaf ({largest} elements) {adamw_gb:.2f} + logits {logits_gb:.2f}; "
        f"launches {launches}, flash by route {flash_routes}, backward calls {dict(ops.FLASH_BWD)}")
    profile_train_step(torch, model, opt_cfg, step_fn, state, batches[steps], label)
    return counts


def train_mamba(torch, ops, steps: int = 4):
    """Main path 4: mamba2-370m at full width and depth through the
    training entry point, train_loop(reduced=False, batch 8, seq 512), with
    each step's launches, loss and time read from a wrapped step function.
    Returns its launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_mod

    records = []
    make = train_mod.make_train_step

    def counted_make(*args, **kwargs):
        step_fn = make(*args, **kwargs)

        return lambda state, batch: timed_step(torch, ops, step_fn, state, batch, records)

    train_mod.make_train_step = counted_make
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        res = train_mod.train_loop("mamba2-370m", reduced=False, steps=steps, batch=8, seq=512,
                                   device="cuda", log_every=1)
        wall = time.perf_counter() - t0
        counts = _launch_counts(ops)
        launches, ssd_routes = dict(ops.LAUNCHES), dict(ops.SSD_ROUTES)
    finally:
        train_mod.make_train_step = make
    cfg = get_config("mamba2-370m")
    L = cfg.n_layers
    assert len(records) == steps and res["final_step"] == steps, (len(records), res)
    check_train_records(cfg, records, {"rmsnorm": 4 * L + 1, "ssd_scan": 2 * L, "ssd/mma": 2 * L},
                        8 * 512, "train mamba2-370m")
    walls = sorted(r["wall"] for r in records[1:])
    log(f"train mamba2-370m: train_loop {res} in {wall:.1f} s; step wall after the first "
        f"{[round(w * 1e3, 3) for w in walls]} ms, {8 * 512 / walls[0]:.1f} tokens/s at the best; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}, "
        f"ssd by route {ssd_routes}")
    profile_mamba_step(torch, cfg)
    return counts


def profile_mamba_step(torch, cfg):
    """One profiled mamba2-370m train step (batch 8 x seq 512) after a
    warm-up step, outside the counted run."""
    from repro_torch.models import Model
    from repro_torch.train.data import DataLoader
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    model = Model(cfg)
    state = init_train_state(model, torch.Generator(device=model.device).manual_seed(0))
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=100)
    step_fn = make_train_step(model, opt_cfg)
    loader = DataLoader(cfg, 8, 512, seed=0)
    warm, batch = ({k: torch.from_numpy(v).to(model.device) for k, v in loader.next().items()}
                   for _ in range(2))
    state, _ = step_fn(state, warm)
    profile_train_step(torch, model, opt_cfg, step_fn, state, batch, "train mamba2-370m")


def small_train_against_cpu(torch, ops, steps: int = 3):
    """Small float32 models (reduced deepseek-7b, qwen3-moe-30b-a3b and
    moonshot-v1-16b-a3b at their head_dim 16, reduced mamba2-370m) trained
    on the card through the kernels and on the CPU through the plain
    versions, from the same weights and batches.  Losses within 1e-5
    relative at every step, and every MoE routing call (forward and remat
    recompute) the same experts and dropped pairs on both.  Params: an Adam
    step is about +-lr wherever the gradient is tiny, so an element whose
    gradient is within float noise of 0 may step the other way on the other
    device; none may differ by more than 2 sum(lr), and at most a 1e-3
    share of a leaf's elements by more than 1e-5."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models import Model
    from repro_torch.train.data import DataLoader
    from repro_torch.train.optimizer import AdamWConfig, cosine_lr
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import leaves_with_paths, tree_map

    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    bound = 2 * sum(float(cosine_lr(opt, torch.tensor(s + 1))) for s in range(steps))
    for arch in ("deepseek-7b", "mamba2-370m", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"):
        cfg = reduced_config(arch)
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
        s_cpu = init_train_state(cpu, torch.Generator().manual_seed(11))
        # a copy: the steps update each state's tensors in place
        s_gpu = tree_map(lambda t: t.to(gpu.device, copy=True), s_cpu)
        f_cpu, f_gpu = make_train_step(cpu, opt), make_train_step(gpu, opt)
        loader = DataLoader(cfg, 4, 40, seed=0)
        loss_err, launches, routed, dropped = 0.0, {}, True, 0
        for step in range(steps):
            batch = {k: torch.from_numpy(v) for k, v in loader.next().items()}
            with RouteLog() as r_cpu:
                s_cpu, m_cpu = f_cpu(s_cpu, batch)
            before = _launch_counts(ops)
            with RouteLog() as r_gpu:
                s_gpu, m_gpu = f_gpu(s_gpu, {k: v.to(gpu.device) for k, v in batch.items()})
            for k, v in _diff(_launch_counts(ops), before).items():
                if v:
                    launches[k] = launches.get(k, 0) + v
            routed = routed and same_routing(torch, step, r_gpu.records, r_cpu.records)
            dropped += sum(int((~r.keep).sum()) for r in r_cpu.records)
            lc, lg = float(m_cpu["loss"]), float(m_gpu["loss"])
            loss_err = max(loss_err, abs(lg - lc) / abs(lc))
        want = dict(leaves_with_paths(s_cpu.params))
        worst, share = 0.0, 0.0
        for key, p in leaves_with_paths(s_gpu.params):
            err = (p.cpu() - want[key]).abs().numpy()
            worst, share = max(worst, float(err.max())), max(share, float(np.mean(err > 1e-5)))
        log(f"small train {arch}: {steps} steps, card kernels vs cpu plain path: worst loss rel err "
            f"{loss_err:.3e} (tol 1e-5); params worst abs err {worst:.3e} (bound {bound:.3e}), "
            f"largest share of a leaf off by > 1e-5 {share:.2e} (tol 1e-3); launches {launches}"
            + (f"; the same experts and dropped pairs in every routing call: {routed} ({dropped} "
               f"pairs dropped over {steps} steps)" if cfg.n_experts else ""))
        L = cfg.n_layers
        mixer = (("ssd_scan", "ssd/fma") if arch == "mamba2-370m"
                 else ("flash_attention", "flash/fma", "flash/fma K=16 causal"))
        assert launches == {"rmsnorm": steps * (2 * norms_a_layer(cfg) * L + 1),
                            **{k: steps * 2 * L for k in mixer}}, launches
        assert routed and loss_err <= 1e-5 and worst <= bound and share <= 1e-3, \
            (routed, loss_err, worst, share)


def resume_on_card(torch):
    """train_loop on reduced mamba2-370m on the card: fail after step 6 of
    10 (checkpoints every 4, in a temporary directory deleted afterwards),
    resume from step 4; the final loss must equal a straight run's."""
    import tempfile

    from repro_torch.launch.train import train_loop

    kw = dict(steps=10, batch=4, seq=64, ckpt_every=4, log_every=100, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            train_loop("mamba2-370m", ckpt_dir=f"{tmp}/a", fail_at=6, **kw)
        except RuntimeError as e:
            assert "injected failure at step 6" in str(e), e
        else:
            raise AssertionError("train_loop did not fail at step 6")
        resumed = train_loop("mamba2-370m", ckpt_dir=f"{tmp}/a", **kw)
        straight = train_loop("mamba2-370m", ckpt_dir=f"{tmp}/b", **kw)
    log(f"resume: failed after step 6, resumed from step 4: last loss {resumed['last_loss']!r}; "
        f"straight run {straight['last_loss']!r}")
    assert resumed["last_loss"] == straight["last_loss"], (resumed, straight)


# --------------------------------------------------------------------------
# phase 10: the vlm, audio, sliding-window and hybrid families
# --------------------------------------------------------------------------


def counted_call(torch, ops, fn, *args, **kwargs):
    """(fn's result, its wall ms to a synchronised end, the launches it made:
    nonzero counts only, by kernel, route and flash shape)."""
    before = _launch_counts(ops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, {k: v for k, v in _diff(_launch_counts(ops), before).items() if v}


def last_logits(model, params, inputs, rows):
    """Logits [B, len(rows), V] at the given positions of a cache-free
    forward over the whole input (the backbone as Model.loss runs it,
    without remat)."""
    import torch

    from repro_torch.models import layers as L

    h, _ = model._embed_inputs(params, inputs)
    q_pos = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    h, _ = model._backbone(params, h, q_pos)
    return L.unembed(params["embed"], model.cfg, L.rms_norm(h[:, rows], params["final_norm"]))


def vlm_phase(torch, np, ops, dev):
    """Main path 6: llava-next-mistral-7b at full width and depth, bf16.
    Prefill of 2 rows, each 1,152 image embeddings (seeded normal) and a
    200-token prompt (Sq = 1,352 on mma_prefill, 4 query heads a KV head),
    then 16 decode steps in lockstep; every pass's launches counted.  The
    last step's logits against a prefill of the whole sequence (relative
    L2 <= 5e-2, as for deepseek-7b).  Returns its launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("llava-next-mistral-7b")
    params = init_params(torch, Model, cfg, dev)
    model = Model(cfg)
    n, Ti, St, steps = cfg.n_layers, cfg.vlm_img_tokens, 200, 16
    rng = np.random.default_rng(14)
    pe = torch.from_numpy(rng.normal(size=(2, Ti, cfg.frontend_dim)).astype(np.float32)).to(dev)
    text = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, St + steps)).astype(np.int32)).to(dev)
    S = Ti + St
    prompt = {"tokens": text[:, :St], "patch_embeds": pe}
    model.prefill(params, {"tokens": text[:, :8], "patch_embeds": pe[:, :8]})  # warm-up
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(2, S + steps)
    (logits, _), pre_ms, pre_l = counted_call(torch, ops, model.prefill, params, prompt, cache)
    dec_ms, dec = [], None
    for i in range(steps):
        (dec, _), ms, got = counted_call(torch, ops, model.decode_step, params, cache,
                                         text[:, St + i : St + i + 1], S + i)
        dec_ms.append(ms)
        assert got == {"rmsnorm": 2 * n + 1, "flash_attention": n, "flash/decode": n,
                       f"flash/decode K={cfg.head_dim} causal": n}, (i, got)
    counts = _launch_counts(ops)
    launches, routes = dict(ops.LAUNCHES), dict(ops.FLASH_ROUTES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert pre_l == {"rmsnorm": 2 * n + 1, "flash_attention": n, "flash/mma_prefill": n,
                     f"flash/mma_prefill K={cfg.head_dim} causal": n}, pre_l
    assert logits.shape == (2, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all())
    assert bool(torch.isfinite(dec).all())
    dec_ms.sort()
    log(f"vlm {cfg.name}: prefill of 2 x ({Ti} image + {St} text) = 2 x {S} rows {pre_ms:.3f} ms "
        f"= {2 * S / pre_ms * 1e3:.1f} rows/s; {steps} decode steps at batch 2, ms median "
        f"{dec_ms[steps // 2]:.3f} (min {dec_ms[0]:.3f}, max {dec_ms[-1]:.3f}); peak memory "
        f"{peak:.2f} GiB (cache {2 * (S + steps)} rows); launches {launches}, flash by route {routes}; "
        f"a prefill {pre_l}")
    # decode step 16 saw text[:, :St+16]: a prefill of it gives its logits
    full = last_logits(model, params, {"tokens": text, "patch_embeds": pe}, [S + steps - 1])
    errs = [rel_err(dec[r, 0], full[r, 0]) for r in range(2)]
    control = rel_err(dec[1, 0], full[0, 0])
    log(f"vlm {cfg.name}: consistency of decode step {steps} with a prefill of the whole "
        f"sequence ({Ti} image + {St + steps} text rows): rel L2 {errs} (tol 5e-2); control "
        f"(row 1 against row 0) {control:.4f}")
    assert max(errs) <= 5e-2, errs
    cache = model.init_cache(2, S + steps)
    model.prefill(params, prompt, cache)
    profile_calls(torch, f"{cfg.name} prefill 2 x {S}", lambda: model.prefill(params, prompt))
    profile_calls(torch, f"{cfg.name} decode step at batch 2", lambda: model.decode_step(
        params, cache, text[:, St : St + 1], S), calls=5)
    return counts


def audio_phase(torch, np, ops, dev):
    """Main path 7: hubert-xlarge at full width and depth, bf16 (48 layers,
    16 heads of 80, non-causal, GeLU MLP).  A prefill over frames of 8 x
    500 (10 s at 50 frames/s), then 3 train steps at that batch through
    make_train_step on the masked-frame batches of DataLoader; every
    attention launch on mma_prefill at K=80, non-causal.  A prefill of one
    row through the kernels against the plain versions on the card, and
    the step-0 loss near ln V + s^2/2.  Returns the prefill's and the
    train steps' launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import n_params
    from repro_torch.train.data import DataLoader
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = get_config("hubert-xlarge")
    model = Model(cfg)
    n, B, S = cfg.n_layers, 8, 500
    shape = f"flash/mma_prefill K={cfg.head_dim} non-causal"
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0))
    log(f"audio {cfg.name}: {n_params(state.params)} params, train state "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB (bf16 params, fp32 m and v)")
    loader = DataLoader(cfg, B, S, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in loader.next().items()} for _ in range(4)]
    frames = {"frames": batches[0]["frames"]}
    model.prefill(state.params, {"frames": frames["frames"][:1, :16]})  # warm-up
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    (logits, _), pre_ms, pre_l = counted_call(torch, ops, model.prefill, state.params, frames)
    assert pre_l == {"rmsnorm": 2 * n + 1, "flash_attention": n, "flash/mma_prefill": n,
                     shape: n}, pre_l
    assert logits.shape == (B, 1, cfg.padded_vocab) and bool(torch.isfinite(logits).all())
    prefill_counts = _launch_counts(ops)
    log(f"audio {cfg.name}: prefill over {B} x {S} frames {pre_ms:.3f} ms = "
        f"{B * S / pre_ms * 1e3:.1f} frames/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the train state resident); "
        f"launches {pre_l}")
    kernels_against_plain(torch, ops, model, state.params, {"frames": frames["frames"][:1]},
                          f"{cfg.name} prefill 1 x {S}")

    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=100)
    step_fn = make_train_step(model, opt_cfg)
    records = []
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for batch in batches[:3]:
        state, _ = timed_step(torch, ops, step_fn, state, batch, records)
    train_counts = _launch_counts(ops)
    peak = torch.cuda.max_memory_allocated() / 2**30
    labels = sum(int((b["labels"] >= 0).sum()) for b in batches[:3])
    # forward and remat recompute, all non-causal at K=80
    check_train_records(cfg, records, {"rmsnorm": 4 * n + 1, "flash_attention": 2 * n,
                                       "flash/mma_prefill": 2 * n, shape: 2 * n},
                        B * S, f"train {cfg.name}")
    assert ops.FLASH_BWD == {f"kernel K={cfg.head_dim} non-causal": 3 * n}, ops.FLASH_BWD
    walls = sorted(r["wall"] for r in records[1:])
    log(f"train {cfg.name}: 3 steps at batch {B} x {S} frames ({labels} masked-frame labels in "
        f"all); step wall after the first {[round(w * 1e3, 3) for w in walls]} ms; peak memory "
        f"{peak:.2f} GiB; launches {dict(ops.LAUNCHES)}, flash by shape {dict(ops.FLASH_SHAPES)}")
    profile_calls(torch, f"{cfg.name} prefill {B} x {S}", lambda: model.prefill(state.params, frames))
    profile_train_step(torch, model, opt_cfg, step_fn, state, batches[3], f"train {cfg.name}")
    return prefill_counts, train_counts


def kernels_against_plain(torch, ops, model, params, inputs, label, tol=5e-2):
    """Last-position logits of one prefill through the kernels against the
    same prefill with the wrappers swapped for their plain versions
    (``PlainKernels``), on the card, in the model's type (relative L2 <=
    tol).  Each MoE routing call of the plain pass takes the experts the
    kernel pass chose (bf16 rounds the two passes' router scores apart near
    ties); a model without MoE makes none."""
    with RouteLog() as rl:
        got = model.prefill(params, inputs)[0].float()
    with PlainKernels(torch, ops), PinnedRouting() as pr:
        pr.pins = [r.top_i for r in rl.records]
        want = model.prefill(params, inputs)[0].float()
    err = rel_err(got, want)
    log(f"{label}: logits through the kernels against the plain versions on the card, rel L2 "
        f"{err:.3e} (tol {tol}); {len(rl.records)} routing calls pinned to the kernel pass's, "
        f"{pr.differ} token choices would differ")
    assert bool(torch.isfinite(got).all()) and err <= tol, err


def plain_versions(torch):
    """Each kernel wrapper's plain version, called as the wrapper is: the
    SSD scan's output in the asked type, flash attention over query rows in
    chunks whose fp32 scores take at most FLASH_PLAIN_BYTES (a row's output
    reads its query row alone)."""
    from repro_torch.kernels import ref

    def ssd_plain(x, dt, A, Bm, Cm, chunk, init_state=None, out_dtype=torch.float32):
        y, state = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk, init_state)
        return y.to(out_dtype), state

    def flash_plain(q, k, v, q_pos, kv_pos, causal=True, window=None):
        B, Sq, H, _ = q.shape
        rows = max(1, FLASH_PLAIN_BYTES // (B * H * k.shape[1] * 4))
        return torch.cat([ref.flash_attention_ref(q[:, i:i + rows], k, v, q_pos[..., i:i + rows],
                                                  kv_pos, causal, window)
                          for i in range(0, Sq, rows)], dim=1)

    return {"rmsnorm": ref.rmsnorm_ref, "flash_attention": flash_plain, "ssd_scan": ssd_plain}


class PlainKernels:
    """While installed, the kernel wrappers are their plain versions
    (``plain_versions``): no kernel may launch."""

    def __init__(self, torch, ops):
        self.ops, self.plain = ops, plain_versions(torch)

    def __enter__(self):
        self.saved = {name: getattr(self.ops, name) for name in self.plain}
        self.launches = dict(self.ops.LAUNCHES)
        for name, fn in self.plain.items():
            setattr(self.ops, name, fn)
        return self

    def __exit__(self, *exc):
        for name, wrapper in self.saved.items():
            setattr(self.ops, name, wrapper)
        assert exc[0] is not None or self.ops.LAUNCHES == self.launches, \
            "a kernel ran in the plain pass"


def swa_phase(torch, np, ops, dev):
    """Main path 8: h2o-danube-3-4b at full width and depth, bf16 (24
    layers, 32 query heads on 8 KV heads of 120, window 4096).  One row of
    8,192 tokens (two windows) prefilled into a 4,096-slot ring, then 16
    decode steps that overwrite slots 0-15; each step's logits against a
    cache-free forward over the whole sequence (relative L2 <= 5e-2).
    Returns its launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("h2o-danube-3-4b")
    params = init_params(torch, Model, cfg, dev)
    model = Model(cfg)
    n, S, steps, W = cfg.n_layers, 8192, 16, cfg.sliding_window
    toks = torch.from_numpy(
        np.random.default_rng(15).integers(0, cfg.vocab_size, (1, S + steps)).astype(np.int32)).to(dev)
    model.prefill(params, {"tokens": toks[:, :8]})  # warm-up
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    cache = model.init_cache(1, S + steps)
    ring = cache["sub0"]["k"].shape[2]
    ring_mb = sum(t.numel() * t.element_size() for c in cache.values() for t in c.values()) / 1e6
    (logits, _), pre_ms, pre_l = counted_call(torch, ops, model.prefill, params,
                                              {"tokens": toks[:, :S]}, cache)
    assert ring == W and pre_l == {"rmsnorm": 2 * n + 1, "flash_attention": n,
                                   "flash/mma_prefill": n,
                                   f"flash/mma_prefill K={cfg.head_dim} causal window": n}, pre_l
    pos = cache["sub0"]["pos"][0, 0]
    assert torch.equal(pos, torch.arange(S - W, S, dtype=torch.int32, device=dev)), "ring after prefill"
    decs, dec_ms = [], []
    for i in range(steps):
        (dec, _), ms, got = counted_call(torch, ops, model.decode_step, params, cache,
                                         toks[:, S + i : S + i + 1], S + i)
        decs.append(dec[0, 0])
        dec_ms.append(ms)
        assert got == {"rmsnorm": 2 * n + 1, "flash_attention": n, "flash/decode": n,
                       f"flash/decode K={cfg.head_dim} causal window": n}, (i, got)
    counts = _launch_counts(ops)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want_pos = torch.arange(S - W, S + steps, dtype=torch.int32, device=dev)
    want_pos = torch.cat([want_pos[-steps:], want_pos[steps:W]])  # slots 0-15 overwritten
    assert torch.equal(cache["sub0"]["pos"][0, 0], want_pos), "ring after the wrap"
    dec_ms.sort()
    log(f"swa {cfg.name}: {ring}-slot ring, cache {ring_mb:.1f} MB a row; prefill of 1 x {S} "
        f"{pre_ms:.3f} ms = {S / pre_ms * 1e3:.1f} tokens/s; {steps} decode steps over slots "
        f"0-{steps - 1}, ms median {dec_ms[steps // 2]:.3f} (min {dec_ms[0]:.3f}, max "
        f"{dec_ms[-1]:.3f}); peak memory {peak:.2f} GiB; launches {launches}, flash by shape "
        f"{dict(ops.FLASH_SHAPES)}")
    full = last_logits(model, params, {"tokens": toks}, list(range(S, S + steps)))[0]
    errs = [rel_err(d, f) for d, f in zip(decs, full)]
    control = rel_err(decs[1], full[0])
    log(f"swa {cfg.name}: each decode step against a cache-free forward over all "
        f"{S + steps} tokens: rel L2 max {max(errs):.4f}, by step {[round(e, 4) for e in errs]} "
        f"(tol 5e-2); control (step 1 against step 0's row) {control:.4f}")
    assert bool(torch.isfinite(logits).all()) and max(errs) <= 5e-2, errs
    profile_calls(torch, f"{cfg.name} prefill 1 x {S}",
                  lambda: model.prefill(params, {"tokens": toks[:, :S]}, model.init_cache(1, S)))
    profile_calls(torch, f"{cfg.name} decode step over the ring", lambda: model.decode_step(
        params, cache, toks[:, S : S + 1], S + steps), calls=5)
    return counts


def hybrid_against_cpu(torch, np, ops, cfg, seed, label):
    """A hybrid ``cfg`` (fp32) on the card through the kernels against the
    same weights on the CPU through the plain versions: a prefill of 2 x 12
    tokens and 4 decode steps at per-row positions; logits within 1e-4, the
    same experts and dropped pairs in every routing call, and every
    attention launch the prefill's fma and the decode steps' decode route
    at the config's head dim.  Returns the card's params and the CPU's."""
    from repro_torch.models import Model

    tol = 1e-4
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(seed))
    p_gpu = _tree_to(p_cpu, gpu.device)
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))

    def run(model, params):
        dev = model.device
        cache = model.init_cache(2, 32)
        with RouteLog() as rl:
            outs = [model.prefill(params, {"tokens": toks[:, :12].to(dev)}, cache)[0].cpu()]
            for i in range(4):
                pos = torch.tensor([12 + i, 12 + i], dtype=torch.int32, device=dev)
                outs.append(model.decode_step(params, cache, toks[:, 12 + i : 13 + i].to(dev), pos)[0].cpu())
        return outs, [(r.capacity, r.top_i.cpu(), r.keep.cpu()) for r in rl.records]

    before = _launch_counts(ops)
    out_gpu, r_gpu = run(gpu, p_gpu)
    shapes = _flash_shapes(_diff(_launch_counts(ops), before))
    out_cpu, r_cpu = run(cpu, p_cpu)
    worst = max((a - b).abs().max().item() for a, b in zip(out_gpu, out_cpu))
    same = len(r_gpu) == len(r_cpu) == 5 * moe_layers(cfg) and all(
        a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
        for a, b in zip(r_gpu, r_cpu))
    dropped = sum(int((~keep).sum()) for *_, keep in r_gpu)
    n_attn = hybrid_layers(cfg)[0]
    log(f"{label}: card kernels vs cpu plain path, prefill 2 x 12 + 4 decode steps: max abs logit "
        f"err {worst:.3e} (tol {tol}); the same experts and dropped pairs in all {len(r_gpu)} "
        f"routing calls: {same} ({dropped} pairs dropped); flash by shape {shapes}")
    assert same and worst <= tol, (same, worst)
    K = cfg.head_dim
    assert shapes == {f"fma K={K} causal": n_attn, f"decode K={K} causal": 4 * n_attn}, shapes
    return p_gpu, p_cpu


def hybrid_phase(torch, np, ops):
    """The hybrid family on the card, cut: reduced jamba-1.5-large-398b
    (two super-blocks of 8 layers: attention at the 5th, Mamba elsewhere,
    MoE on every 2nd) at its own head_dim 16, fp32.  Prefill of 2 x 12 tokens and
    4 decode steps at per-row positions on the card against the CPU
    (``hybrid_against_cpu``); then ServeEngine serves prompts of 3 or more
    tokens on the card, every pass's launches counted, with the CPU
    engine's tokens.  Returns the served run's launches."""
    from repro_torch.configs import reduced_config
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = reduced_config(JAMBA)
    p_gpu, p_cpu = hybrid_against_cpu(torch, np, ops, cfg, 16,
                                      f"hybrid {cfg.name} (reduced, head_dim {cfg.head_dim}, fp32)")
    n_attn, n_mamba, norms = hybrid_layers(cfg)
    counts = serve(
        torch, np, cfg, p_gpu, ops, lengths=[3, 12, 5, 7],
        per_pass={"rmsnorm": (norms, norms), "flash_attention": (n_attn, n_attn),
                  "ssd_scan": (n_mamba, 0)},
        routes={"flash_attention": {"prefill": "fma", "decode": "decode"},
                "ssd_scan": {"prefill": "fma", "decode": "fma"}},
    )
    rng = np.random.default_rng(18)
    prompts = [rng.integers(0, cfg.vocab_size, m).tolist() for m in (3, 9, 4, 6)]
    tokens = [ServeEngine(cfg, p, max_len=64, batch_size=2, seed=3, device=d).generate(
        [Request(i, list(q), 8, t) for i, (q, t) in enumerate(zip(prompts, (0.0, 0.8, 0.0, 0.8)))])
        for p, d in ((p_gpu, "cuda"), (p_cpu, "cpu"))]
    log(f"hybrid {cfg.name}: ServeEngine on the card, prompts of {[len(q) for q in prompts]} tokens, "
        f"8 new tokens each (greedy and sampled): {tokens[0]}; the same as on the cpu: "
        f"{tokens[0] == tokens[1]}")
    assert tokens[0] == tokens[1], tokens
    return counts


# --------------------------------------------------------------------------
# phase 10b: the two dense giants
# --------------------------------------------------------------------------


def dense_giants_phase(torch, np, ops, dev):
    """Main path 1 on qwen3-32b (qk-norm, 64 query heads on 8 KV heads) and
    granite-34b (48 query heads on one KV head, the non-gated GeLU MLP) at
    full width and depth in bf16, each freed before the next: ServeEngine
    serves 4 requests of 16 new tokens, every pass launching norms a layer
    x n + 1 RMSNorm and n flash kernels (prefill mma_prefill, decode
    decode); prefill/decode consistency, a profiled decode step, and the
    reduced config (head_dim 16, fp32) on the card against the CPU.
    Returns each serve run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    counts = {}
    for arch in ("qwen3-32b", "granite-34b"):
        cfg = get_config(arch)
        params = init_params(torch, Model, cfg, dev)
        log_kv_cache(cfg)
        n = cfg.n_layers
        counts[arch] = serve(
            torch, np, cfg, params, ops, lengths=NEW_PATH_PROMPTS,
            per_pass={"rmsnorm": (norms_a_layer(cfg) * n + 1,) * 2, "flash_attention": (n, n),
                      "ssd_scan": (0, 0)},
            routes={"flash_attention": {"prefill": "mma_prefill", "decode": "decode"}},
        )
        dense_consistency(torch, np, cfg, params)
        profile_decode(torch, cfg, params, steps=NEW_PATH_PROFILED_STEPS)
        del params
        torch.cuda.empty_cache()
        small_model_against_cpu(torch, np, ops, arch)
    return counts


# --------------------------------------------------------------------------
# phase 10c: jamba-1.5-large-398b at its own widths
# --------------------------------------------------------------------------

JAMBA = "jamba-1.5-large-398b"


def jamba_cut_config():
    """jamba-1.5-large-398b at every one of its own widths (d_model 8192,
    d_ff 24576, 64 query heads on 8 KV heads of 128, 256 SSM heads of 64,
    ssm_state 128, vocab 65,536, 16 experts top-2), cut to one super-block
    of 8 layers with MoE on every 4th (positions 3 and 7): 27.03 G
    parameters, 54.05 GB in bf16.  The published super-block (MoE on every
    2nd layer) is 45.14 G, 90.3 GB, more than one card holds; cutting the
    expert count instead would change the router's width and its routing."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(JAMBA), n_layers=8, moe_period=4)


def jamba_mid_config(dtype: str):
    """The reduced jamba-1.5-large-398b at a width whose kernels take their
    tensor-core routes in bf16 (head_dim 64; SSD N 64, P 32, chunk 64), and
    which the CPU also holds: one super-block of 8 layers, MoE on every 4th."""
    from repro_torch.configs import reduced_config

    return reduced_config(JAMBA, n_layers=8, moe_period=4, d_model=256, n_heads=4, n_kv_heads=2,
                          head_dim=64, ssm_state=64, ssm_head_dim=32, ssm_chunk=64, dtype=dtype)


def largest_draw_bytes(cfg) -> int:
    """The fp32 scratch of init's largest draw: a stacked leaf is drawn one
    block slice at a time (``("by_slice", init)``), any other leaf whole."""
    import math

    from repro_torch.models.model import param_spec

    def walk(spec):
        if isinstance(spec, dict):
            return max(walk(v) for v in spec.values())
        shape, init = spec
        if isinstance(init, tuple) and init[0] == "by_slice":
            shape = shape[1:]
        return 4 * math.prod(shape)

    return walk(param_spec(cfg))


def jamba_cut_phase(torch, np, ops, dev):
    """jamba-1.5-large-398b at its own widths in bf16 (``jamba_cut_config``):
    init (its peak against the reckoning: the parameters and the fp32
    scratch of the largest draw), then ServeEngine(max_len=512,
    batch_size=4) serves NEW_PATH_PROMPTS of 16 new tokens, every pass 24
    RMSNorm and one flash launch (mma_prefill, decode) and every prefill 7
    SSD scans on mma, each prefill's dropped pairs logged and none on a
    decode step; prefill/decode consistency with capacity raised
    (``moe_consistency``); a 1 x 200 prefill through the kernels against
    the plain versions with the routing pinned; a profiled decode step.
    Returns the serve run's launches."""
    from repro_torch.models import Model
    from repro_torch.tree import leaves, leaves_with_paths

    cfg = jamba_cut_config()
    params = init_params(torch, Model, cfg, dev)
    peak = torch.cuda.max_memory_allocated()
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    scratch = largest_draw_bytes(cfg)
    log(f"init {cfg.name} cut to n_layers {cfg.n_layers}, moe_period {cfg.moe_period}: peak "
        f"{peak / 1e9:.2f} GB against the reckoning {(param_bytes + scratch) / 1e9:.2f} GB "
        f"(params {param_bytes / 1e9:.2f} GB and the fp32 scratch of the largest draw "
        f"{scratch / 1e9:.2f} GB)")
    n_attn, n_mamba, norms = hybrid_layers(cfg)
    cache = Model(cfg, device="meta").init_cache(1, 512)
    kv = sum(t.nbytes for k, t in leaves_with_paths(cache) if k.split("/")[-1] in ("k", "v")) // 512
    state = sum(t.nbytes for k, t in leaves_with_paths(cache) if k.split("/")[-1] in ("ssm", "conv"))
    log(f"init {cfg.name}: KV cache {kv / 1024:.0f} KiB a token ({n_attn} attention layer), "
        f"{4 * 512 * kv / 2**20:.0f} MiB at batch 4 x 512; Mamba state and conv window "
        f"{state / 2**20:.2f} MiB a row ({n_mamba} Mamba layers)")
    counts = serve_moe(
        torch, np, cfg, params, ops, NEW_PATH_PROMPTS,
        per_pass={"rmsnorm": (norms, norms), "flash_attention": (n_attn, n_attn),
                  "ssd_scan": (n_mamba, 0)},
        routes={"flash_attention": {"prefill": "mma_prefill", "decode": "decode"},
                "ssd_scan": {"prefill": "mma", "decode": "mma"}})
    moe_consistency(torch, np, cfg, params, near_tie_flips=True)
    tok = torch.from_numpy(np.random.default_rng(19).integers(
        0, cfg.vocab_size, (1, 200)).astype(np.int32)).to(dev)
    kernels_against_plain(torch, ops, Model(cfg), params, {"tokens": tok},
                          f"{cfg.name} cut prefill 1 x 200")
    profile_decode(torch, cfg, params, steps=NEW_PATH_PROFILED_STEPS,
                   bounds=moe_weight_bytes(cfg, params, 4))
    del params
    torch.cuda.empty_cache()
    return counts


def jamba_mid_bf16(torch, np, ops, dev):
    """``jamba_mid_config("bfloat16")`` on the card: a prefill of 2 x 100
    tokens and 4 decode steps at per-row positions through the kernels,
    against the same calls through the plain versions on the card with
    each routing call pinned to the kernel pass's; every logit row within
    5e-2 relative L2.  The prefill's flash launch takes mma_prefill at K=64
    and its SSD scans mma.  Returns the kernel pass's launches."""
    from repro_torch.models import Model

    tol = 5e-2
    cfg = jamba_mid_config("bfloat16")
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(20))
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (2, 104)).astype(np.int32)).to(dev)

    def run():
        cache = model.init_cache(2, 128)
        outs = [model.prefill(params, {"tokens": toks[:, :100]}, cache)[0].float()]
        for i in range(4):
            pos = torch.tensor([100 + i, 100 + i], dtype=torch.int32, device=dev)
            outs.append(model.decode_step(params, cache, toks[:, 100 + i : 101 + i], pos)[0].float())
        return outs

    ops.reset_launches()
    with RouteLog() as rl:
        got = run()
    counts = _launch_counts(ops)
    with PlainKernels(torch, ops), PinnedRouting() as pr:
        pr.pins = [r.top_i for r in rl.records]
        want = run()
    worst = max(rel_rows(g, w, 2) for g, w in zip(got, want))
    n_attn, n_mamba, norms = hybrid_layers(cfg)
    launches = {k: v for k, v in counts.items() if v}
    log(f"hybrid {cfg.name} mid width (d_model {cfg.d_model}, head_dim {cfg.head_dim}, ssm_state "
        f"{cfg.ssm_state}, ssm_head_dim {cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}, {cfg.n_layers} "
        f"layers, moe_period {cfg.moe_period}), bf16: prefill 2 x 100 + 4 decode steps through "
        f"the kernels against the plain versions on the card, worst logit row rel L2 {worst:.3e} "
        f"(tol {tol}); {len(rl.records)} routing calls pinned to the kernel pass's, {pr.differ} "
        f"token choices would differ; launches {launches}")
    K = cfg.head_dim
    assert launches == {"rmsnorm": 5 * norms, "flash_attention": 5 * n_attn, "ssd_scan": n_mamba,
                        "flash/mma_prefill": n_attn, f"flash/mma_prefill K={K} causal": n_attn,
                        "flash/decode": 4 * n_attn, f"flash/decode K={K} causal": 4 * n_attn,
                        "ssd/mma": n_mamba}, launches
    assert all(bool(torch.isfinite(g).all()) for g in got) and worst <= tol, worst
    return counts


def jamba_phase(torch, np, ops, dev):
    """Phase 10c: the cut at full width, then the mid width in bf16 against
    the plain versions on the card and in fp32 against the CPU.  Returns
    each path's launches."""
    counts = {f"{JAMBA}/cut": jamba_cut_phase(torch, np, ops, dev)}
    counts[f"{JAMBA}/mid bf16"] = jamba_mid_bf16(torch, np, ops, dev)
    cfg = jamba_mid_config("float32")
    ops.reset_launches()
    hybrid_against_cpu(torch, np, ops, cfg, 22,
                       f"hybrid {cfg.name} mid width (d_model {cfg.d_model}, head_dim "
                       f"{cfg.head_dim}, ssm_state {cfg.ssm_state}), fp32")
    counts[f"{JAMBA}/mid fp32"] = _launch_counts(ops)
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# phase 11: the parallel and launch layer
# --------------------------------------------------------------------------

class EveryCell:
    """Every (arch, shape) of the dry run: each arch of the registry at each
    of its ``applicable_shapes`` (32 cells), read when iterated, since the
    port is on the path only once ``main`` has put it there."""

    def __iter__(self):
        from repro_torch.configs import applicable_shapes, get_config, list_archs

        return iter([(a, s) for a in list_archs() for s in applicable_shapes(get_config(a))])


# The dry run of every cell on the fake 16x16 mesh, the train cells under sp
# (dryrun_opts); each must fit one H100, and every
# distinct kernel call they hand a device is replayed on the card
# (replay_phase).  The cells run in DRYRUN_WORKERS spawned processes from the
# start of the run (BackgroundDryRuns), beside the card phases.
DRYRUN_CELLS = EveryCell()
DRYRUN_WORKERS = 3
# Each train cell's (peak bytes, FLOPs) a device on 16x16 under sp, as torch
# 2.13 counts them on the CPU: `python -m repro_torch.launch.dryrun --arch A
# --shape train_4k --opt sp` on torch 2.13.0+cpu at commit fcfe671 (PERF.md,
# PR 29).  The dry run of any torch must count them within TRAIN_RECORD_TOL:
# below 2.13 the model runs its products on the sequence rows as 2.13 places
# them (repro_torch.models.layers.on_sequence_rows), so the card's torch 2.11
# counts what 2.13 counts (ROADMAP.md C9).
TRAIN_RECORD_2_13 = {
    ("deepseek-7b", "train_4k"): (10322267136, 239409597251584),
    ("granite-34b", "train_4k"): (19245313024, 1173077002027008),
    ("h2o-danube-3-4b", "train_4k"): (9959864832, 147981147832320),
    ("hubert-xlarge", "train_4k"): (5035416576, 49154579496960),
    ("jamba-1.5-large-398b", "train_4k"): (77427523072, 3443510699098112),
    ("llava-next-mistral-7b", "train_4k"): (10877611008, 260469700952064),
    ("mamba2-370m", "train_4k"): (3753536512, 13198988148736),
    ("moonshot-v1-16b-a3b", "train_4k"): (12721892864, 172973398949888),
    ("qwen3-32b", "train_4k"): (22232419328, 1148923162918912),
    ("qwen3-moe-30b-a3b", "train_4k"): (14546990080, 184138971742208),
}
TRAIN_RECORD_TOL = 0.01
# the distinct kernel calls of the 32 cells a device gets, on torch 2.13
# (the same run) and, since C9's repair, on 2.11
DRYRUN_CALLS = 67
# The cells run on the card, on a (1, 1) mesh: (arch, shape, batch cut to
# (None: not cut), layers cut to (None: not cut), opts, launches a step by
# kernel, route, head dim and mask, the cut as PERF.md states it).
CARD_CELLS = (
    ("mamba2-370m", "long_500k", None, None, (), {"rmsnorm": 97},
     "not cut: one decode step"),
    ("h2o-danube-3-4b", "long_500k", None, None, (),
     {"rmsnorm": 49, "flash/decode K=120 causal window": 24},
     "not cut: the 4,096-slot ring, one decode step at its last slot, every slot written"),
    ("deepseek-7b", "decode_32k", 2, None, (), {"rmsnorm": 61, "flash/decode K=128 causal": 30},
     "batch 128 -> 2: a full 32,768-slot cache"),
    ("mamba2-370m", "train_4k", 8, None, (), {"rmsnorm": 193, "ssd/mma": 96},
     "batch 256 -> 8: loss, grads and AdamW"),
    ("deepseek-7b", "train_4k", 2, 8, (), {"rmsnorm": 33, "flash/mma_prefill K=128 causal": 16},
     "batch 256 -> 2, layers 30 -> 8 (AdamW for 30 needs 82.9 GB): loss, grads and AdamW"),
    ("qwen3-moe-30b-a3b", "decode_32k", 2, None, ("moe_a2a",),
     {"rmsnorm": 193, "flash/decode K=128 causal": 48},
     "batch 128 -> 2: a full 32,768-slot cache; moe_a2a on a model group of one rank"),
    ("qwen3-moe-30b-a3b", "prefill_32k", 1, None, (),
     {"rmsnorm": 193, "flash/mma_prefill K=128 causal": 48},
     "batch 32 -> 1: 32,768 tokens through the placed MoE dispatch (no moe_a2a), "
     "its [128, 2560, 2048] slab beside 57 GiB of weights and a 3.2 GB cache"),
)
# measured / predicted per-device peak of a step: PERF.md's first
# prediction set 0.97-1.15; the first runs read 0.9999994-1.00025 in every
# cell, so the band is held at that reading's width
PEAK_BAND = (0.999, 1.01)
# a kernel call's worst row relative L2 against its plain version on the
# same inputs (the flash cases' bf16 row tolerance)
PLAIN_TOL = 1e-2
# the plain flash attention runs over query rows in chunks whose fp32
# scores take at most this much (a row's output reads its query row alone)
FLASH_PLAIN_BYTES = 1 << 30
SEGMENT = 2 << 20  # the caching allocator's large segments are whole 2 MiB


def dryrun_opts(shape: str) -> tuple:
    """The options a dry-run cell runs under: ``sp`` for a train cell."""
    from repro_torch.configs import SHAPES

    return ("sp",) if SHAPES[shape].kind == "train" else ()


def dryrun_one(arch: str, shape: str, opts: tuple) -> dict:
    """One dry-run cell on a fake group of 256, made and destroyed by
    run_cell (in a worker process of BackgroundDryRuns), with its host
    seconds."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    r = dryrun.run_cell(arch, shape, False, verbose=False, opts=opts)
    assert not dist.is_initialized()
    return {**r, "s": round(time.perf_counter() - t0, 1)}


class BackgroundDryRuns:
    """The dry run of DRYRUN_CELLS, started in DRYRUN_WORKERS spawned worker
    processes (which inherit the path to the port) when the run begins, the
    train cells first (the longest); ``results`` waits for them, and a cell
    that failed fails the run there.  ``close`` ends the workers, finished
    or not."""

    def __init__(self):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        cells = sorted(DRYRUN_CELLS, key=lambda c: not dryrun_opts(c[1]))
        self.t0 = time.perf_counter()
        self.pool = ProcessPoolExecutor(DRYRUN_WORKERS,
                                        mp_context=multiprocessing.get_context("spawn"))
        self.cells = [(arch, shape, self.pool.submit(dryrun_one, arch, shape, dryrun_opts(shape)))
                      for arch, shape in cells]

    def results(self):
        """Each cell's result, one line each and one for the distinct
        kernel calls it hands a device; then every cell is held: ok, and
        fits_h100, and a train cell's peak and FLOPs those of
        TRAIN_RECORD_2_13."""
        import torch

        results, waited = [], time.perf_counter()
        keys = ("fits_h100", "peak_memory_bytes", "state_bytes", "flops", "bytes",
                "coll_bytes", "coll_breakdown", "model_flops", "bottleneck", "kernel_calls")
        for arch, shape, future in self.cells:
            try:
                r = future.result()
            except Exception as e:  # held below, after every cell's line
                r = {"ok": False, "s": None, "error": f"{e!r} from {e.__cause__}"}
            log("dryrun: " + json.dumps({"cell": f"{arch} x {shape} x 16x16",
                                         "opts": list(dryrun_opts(shape)), "s": r["s"],
                                         **{k: r.get(k) for k in ("ok", "error", *keys)}}))
            calls = r.get("kernel_call_shapes", [])
            log(f"dryrun: {arch} x {shape}: {len(calls)} distinct kernel calls a device: "
                + "; ".join(f"{c['count']} x {describe_call(c)}" for c in calls))
            results.append(r)
        now = time.perf_counter()
        log(f"parallel: dry run of {len(results)} cells in {DRYRUN_WORKERS} workers, "
            f"{now - self.t0:.1f} s after they started, {now - waited:.1f} s of it waited for here; "
            f"{sum(r['s'] or 0 for r in results):.1f} s of host time")
        for (arch, shape, _), r in zip(self.cells, results):
            assert r["ok"], r
            assert r["fits_h100"], (arch, shape, r["peak_memory_bytes"])
            if (arch, shape) in TRAIN_RECORD_2_13:
                for got, want in zip((r["peak_memory_bytes"], r["flops"]),
                                     TRAIN_RECORD_2_13[(arch, shape)]):
                    assert abs(got - want) <= TRAIN_RECORD_TOL * want, (
                        arch, shape, torch.__version__, got, want)
            calls = r["kernel_call_shapes"]
            for name, n in r["kernel_calls"].items():
                assert sum(c["count"] for c in calls if c["kernel"] == name) == n, (arch, shape, name)
        return results

    def close(self):
        # the pool's own processes: Python 3.12's executor cannot terminate them
        workers = list(self.pool._processes.values())
        self.pool.shutdown(wait=False, cancel_futures=True)
        for w in workers:
            if w.is_alive():
                w.terminate()
            w.join()


def describe_call(call) -> str:
    """One recorded kernel call (``cost.kernel_call``, or an entry of
    ``dryrun.distinct_calls``) in a line."""
    ins = call["inputs"]

    def t(name):
        return f"[{','.join(map(str, ins[name]['shape']))}] {ins[name]['dtype']}"

    if call["kernel"] == "rmsnorm":
        return f"rmsnorm x {t('x')}"
    if call["kernel"] == "flash_attention":
        return (f"flash_attention q {t('q')}, k {t('k')}, v {t('v')}, "
                f"{'causal' if call['causal'] else 'non-causal'}"
                + (f", window {call['window']}" if call["window"] is not None else "")
                + (", q_pos shared" if call["q_pos_shared"] else ", q_pos per row")
                + (f", decode at {call['decode_pos']}" if call.get("decode_pos") is not None else ""))
    return (f"ssd_scan x {t('x')}, B {t('B')}, dt {t('dt')}, chunk {call['chunk']}, "
            f"y {call['out_dtype']}" + (", init_state" if "init_state" in ins else ""))


def replay_inputs(torch, call, gen, dev):
    """Seeded inputs at the shapes and dtypes of one entry of
    ``dryrun.distinct_calls``, as the kernel wrapper takes them (args,
    kwargs).  Flash attention's positions: a decode step's query at its
    ``decode_pos`` over a cache written as the dry run writes it
    (``dryrun.ring_positions``: a ring of T slots holds the last T
    positions, after its wrap); otherwise the queries are the last Sq of T
    positions written in order."""
    from repro_torch.launch import dryrun

    ins = call["inputs"]
    i32 = dict(dtype=torch.int32, device=dev)

    def draw(name):
        return torch.randn(ins[name]["shape"], generator=gen, device=dev).to(
            getattr(torch, ins[name]["dtype"]))

    if call["kernel"] == "rmsnorm":
        return (draw("x"), draw("scale")), {"eps": call["eps"]}
    if call["kernel"] == "flash_attention":
        q, k, v = draw("q"), draw("k"), draw("v")
        B, Sq, T = q.shape[0], q.shape[1], k.shape[1]
        pos = call["decode_pos"]
        if pos is not None:
            kv_pos, q_pos = dryrun.ring_positions(T, pos, dev), torch.full((Sq,), pos, **i32)
        else:
            kv_pos, q_pos = torch.arange(T, **i32), torch.arange(T - Sq, T, **i32)
        if not call["q_pos_shared"]:
            q_pos = q_pos.expand(B, Sq).contiguous()
        return (q, k, v, q_pos, kv_pos, call["causal"], call["window"]), {}
    x, Bm, Cm = draw("x"), draw("B"), draw("C")
    dt, A = ssd_dt_A(torch, ins["dt"]["shape"], gen, dev)
    init = draw("init_state") if "init_state" in ins else None
    return (x, dt, A, Bm, Cm, call["chunk"]), {
        "init_state": init, "out_dtype": getattr(torch, call["out_dtype"])}


def replay_phase(torch, ops, timer, dev, results):
    """Every distinct local kernel call of the dry-run cells (``results``,
    from ``BackgroundDryRuns.results``, merged by ``dryrun.distinct_calls``) launched on
    the card at its recorded shapes and dtypes (``replay_inputs``) and held
    against its plain version on the same inputs: each output's worst row
    relative L2 within PLAIN_TOL; the route it took, read from the launch
    counters; its ms and bound (``rmsnorm_bound``, ``flash_bound``,
    ``ssd_bound``); one JSON line a call, then a summary by kernel and
    route.  Every kernel must be replayed.  Returns the checked launches
    (one a call; the timed ones are not counted) and the summary."""
    from repro_torch.launch import dryrun

    plain = plain_versions(torch)
    wrapper = {"rmsnorm": ops.rmsnorm, "flash_attention": ops.flash_attention,
               "ssd_scan": ops.ssd_scan}
    prefix = {"rmsnorm": "rmsnorm/", "flash_attention": "flash/", "ssd_scan": "ssd/"}
    keep = CallsAgainstPlain.KEEP

    def counts():
        return {**_launch_counts(ops), **{f"rmsnorm/{r}": n for r, n in ops.RMSNORM_ROUTES.items()}}

    gen = torch.Generator(device=dev).manual_seed(23)
    launched, rows = {}, []
    calls = dryrun.distinct_calls(results)
    assert len(calls) == DRYRUN_CALLS, (len(calls), DRYRUN_CALLS)
    for call in calls:
        name = call["kernel"]
        args, kwargs = replay_inputs(torch, call, gen, dev)
        before = counts()
        got = wrapper[name](*args, **kwargs)
        torch.cuda.synchronize()
        diff = _diff(counts(), before)
        for k, v in diff.items():
            if not k.startswith("rmsnorm/"):
                launched[k] = launched.get(k, 0) + v
        took = {k: v for k, v in diff.items() if v}
        routes = [k[len(prefix[name]):] for k in took if k.startswith(prefix[name]) and " K=" not in k]
        assert len(routes) == 1 and {k: v for k, v in took.items() if " K=" not in k} == {
            name: 1, prefix[name] + routes[0]: 1}, (describe_call(call), took)
        with torch.no_grad():
            want = plain[name](*args, **kwargs)
        outs, wants = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(rel_rows(o, w, keep[name] % o.ndim) for o, w in zip(outs, wants))
        del got, want, outs, wants
        if name == "rmsnorm":
            b_ms, b_by = rmsnorm_bound(args[0])
        elif name == "flash_attention":
            b_ms, b_by = flash_bound(torch, args[0], args[1], *args[3:])
        else:
            b_ms, b_by = ssd_bound(torch, args[0], args[3], args[5], **kwargs)
        row = {"call": describe_call(call), "cells": call["cells"], "route": routes[0],
               "dry_run_calls": call["count"], "worst_row_rel_l2": err, "tol": PLAIN_TOL,
               "ms": timer.ms(lambda: wrapper[name](*args, **kwargs)),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        log("replay: " + json.dumps(row))
        assert err <= PLAIN_TOL, row
        del args, kwargs
        torch.cuda.empty_cache()
    summary = {}
    for name in wrapper:
        mine = [r for r in rows if r["call"].startswith(name)]
        assert mine, f"no dry-run call of {name} was replayed"
        by_route = {}
        for route in sorted({r["route"] for r in mine}):
            these = [r for r in mine if r["route"] == route]
            slowest = max(these, key=lambda r: r["ms"])
            by_route[route] = {"calls": len(these),
                               "worst_row_rel_l2": max(r["worst_row_rel_l2"] for r in these),
                               "slowest": {k: slowest[k] for k in ("call", "ms", "bound_ms")}}
        summary[name] = {"calls": len(mine), "by_route": by_route,
                         "worst_row_rel_l2": max(r["worst_row_rel_l2"] for r in mine)}
    assert len(rows) == len(calls), (len(rows), len(calls))
    log(f"replay: {len(calls)} distinct local kernel calls of {len(results)} dry-run cells on the "
        f"16x16 mesh, {len(rows)} launched on the card, each within {PLAIN_TOL} of its plain "
        f"version: by kernel and route {json.dumps(summary)}")
    return launched, summary


class CallsAgainstPlain:
    """While installed, every kernel wrapper call that comes as DTensors
    runs as it would (``local_map`` to the kernel) and, beside it, the
    kernel's plain version on the same local inputs; each kernel's worst
    row error (``rel_rows``) and its calls are kept.  Plain-tensor calls
    (the wrappers' own, inside ``local_map``) pass as they are."""

    KEEP = {"rmsnorm": -1, "flash_attention": 2, "ssd_scan": 2}  # row dims, per output

    def __init__(self, torch, ops):
        self.torch, self.ops = torch, ops
        self.plain = plain_versions(torch)
        self.worst = {name: 0.0 for name in self.plain}
        self.calls = {name: 0 for name in self.plain}

    def _checked(self, name, wrapper):
        from torch.distributed.tensor import DTensor

        torch = self.torch

        def call(*args, **kwargs):
            out = wrapper(*args, **kwargs)
            if not any(isinstance(a, DTensor) for a in args):
                return out
            local = lambda a: a.to_local() if isinstance(a, DTensor) else a  # noqa: E731
            with torch.no_grad():
                want = self.plain[name](*map(local, args), **{k: local(v) for k, v in kwargs.items()})
            outs, wants = (out, want) if isinstance(out, tuple) else ((out,), (want,))
            for o, w in zip(outs, wants):
                o = local(o).detach()
                keep = self.KEEP[name] % o.ndim
                self.worst[name] = max(self.worst[name], rel_rows(o, w, keep))
            self.calls[name] += 1
            return out

        return call

    def __enter__(self):
        self.saved = {name: getattr(self.ops, name) for name in self.plain}
        for name, wrapper in self.saved.items():
            setattr(self.ops, name, self._checked(name, wrapper))
        return self

    def __exit__(self, *exc):
        for name, wrapper in self.saved.items():
            setattr(self.ops, name, wrapper)


class DryRunBackward:
    """While installed, every flash-attention backward takes the plain
    recompute (``ops._flash_bwd_path``), the backward the dry run prices on
    the meta device: a card cell's step then holds the tensors its dry run
    counted, and its peak is held against the prediction like for like."""

    def __init__(self, ops):
        self.ops = ops

    def __enter__(self):
        self.saved = self.ops._flash_bwd_path
        self.ops._flash_bwd_path = lambda device, dtype: "plain"
        return self

    def __exit__(self, *exc):
        self.ops._flash_bwd_path = self.saved


def card_cell(torch, ops, dev, mesh, arch, shape, batch, layers, opts, per_step, note, steps=5):
    """One dry-run cell on the card, against its dry run on the meta device
    with the same mesh and cut: the state's bytes (exact), the step's peak
    (in PEAK_BAND, on a step whose backward is the plain recompute the dry
    run prices: ``DryRunBackward``; the timed steps, which run the backward
    kernels, may peak no higher), FLOPs and roofline time against the
    step's median device time, and every step's launches by kernel, route
    and shape, all through the wrappers' DTensor branch; one step's every kernel call
    against its plain version on the same inputs; then one step profiled
    (device busy share, time by kernel kind).  Returns the launches of
    the timed steps."""
    import dataclasses
    import gc

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import analysis, dryrun
    from repro_torch.models import Model
    from repro_torch.parallel import opt_flags
    from repro_torch.tree import leaves

    t_cell = time.perf_counter()
    cfg = get_config(arch) if layers is None else dataclasses.replace(get_config(arch), n_layers=layers)
    cell = SHAPES[shape] if batch is None else dataclasses.replace(SHAPES[shape], global_batch=batch)
    meta = Model(cfg, device="meta")
    dryrun.set_opts(meta, cell, mesh, opts)
    t0 = time.perf_counter()
    pred = dryrun.measure(meta, cell, mesh)
    opt_flags.reset()
    mode, predict_s = pred["mode"], time.perf_counter() - t0

    gc.collect()  # nothing of an earlier cell may be freed inside this one's counts
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    requested = lambda: torch.cuda.memory_stats()["requested_bytes.all.current"]  # noqa: E731
    a0, r0 = torch.cuda.memory_allocated(), requested()
    model = Model(cfg, device=dev)
    state = dryrun.build_state(model, cell, mesh, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    state_req, state_alloc = requested() - r0, torch.cuda.memory_allocated() - a0
    n = sum(1 for t in leaves(state) if torch.is_tensor(t))
    assert all(isinstance(t, DTensor) for t in leaves(state) if torch.is_tensor(t))
    assert state_req == pred["state_bytes"], (state_req, pred["state_bytes"])
    # each block the size asked, up to 512 B, or the rest of its 2 MiB segment
    assert pred["state_allocated_bytes"] <= state_alloc <= pred["state_allocated_bytes"] + n * SEGMENT

    dryrun.set_opts(model, cell, mesh, opts)
    try:
        if "moe_a2a" in opts:  # the expert-parallel path against apply_moe, bit for bit
            ep = dryrun.run_step(model, cell, state)[0].to_local()
            opt_flags.set_flags(moe_a2a=False)
            plain = dryrun.run_step(model, cell, state)[0].to_local()
            opt_flags.set_flags(moe_a2a=True)
            assert torch.equal(ep, plain), (ep - plain).abs().max()
            log(f"parallel: {arch} moe_a2a decode logits equal apply_moe's bit for bit "
                f"({tuple(ep.shape)} {ep.dtype})")
            del ep, plain
        elif cfg.family == "moe":
            moe_placed_against_plain(torch, cfg, cell, state, mesh, dev)
        before = _launch_counts(ops)
        with CallsAgainstPlain(torch, ops) as check:
            dryrun.run_step(model, cell, state)
        launched = _diff(_launch_counts(ops), before)
        log(f"parallel: {arch} x {shape}: each kernel call of a step against its plain version "
            f"on the same local inputs, worst row rel L2 {check.worst} (tol {PLAIN_TOL}) over "
            f"calls {check.calls}")
        for name, calls in check.calls.items():
            assert calls == launched.get(name, 0) and check.worst[name] <= PLAIN_TOL, (
                arch, shape, name, calls, launched, check.worst)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with DryRunBackward(ops):
            out = dryrun.run_step(model, cell, state)  # the step the peak is read on
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - a0
        first = out[0] if cell.kind != "train" else out[1]["loss"]
        assert isinstance(first, DTensor) and bool(first.to_local().float().isfinite().all())
        del out, first
        torch.cuda.reset_peak_memory_stats()
        records = []
        for _ in range(steps):
            before = _launch_counts(ops)
            calls = dict(ops.DTENSOR_CALLS)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dryrun.run_step(model, cell, state)
            end.record()
            torch.cuda.synchronize()
            got = _diff(_launch_counts(ops), before)
            through = {k: ops.DTENSOR_CALLS[k] - calls[k] for k in calls}
            records.append((start.elapsed_time(end), got))
            for key, want in per_step.items():
                assert got.get(key, 0) == want, (arch, shape, key, got)
            for name in ops.LAUNCHES:  # every launch came through local_map
                assert got.get(name, 0) == through[name], (name, got, through)
        peak_kernels = torch.cuda.max_memory_allocated() - a0  # the timed steps'
        profile_calls(torch, f"parallel {arch} x {shape}", lambda: dryrun.run_step(model, cell, state))
    finally:
        opt_flags.reset()
    step_ms = sorted(ms for ms, _ in records)[len(records) // 2]
    t_flops = mode.flops / analysis.PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = mode.bytes / analysis.HBM_BYTES_PER_S * 1e3
    ratio = peak / mode.peak_bytes
    row = {
        "cell": f"{arch} x {shape} on the (1, 1) cuda mesh", "reduced": note, "opts": list(opts),
        "state_bytes": {"predicted": pred["state_bytes"], "requested": state_req,
                        "predicted_allocated": pred["state_allocated_bytes"],
                        "allocated": state_alloc, "tensors": n},
        "peak_bytes": {"predicted": mode.peak_bytes, "measured": peak, "ratio": ratio,
                       "measured_with_the_backward_kernels": peak_kernels},
        "flops": mode.flops, "bytes": mode.bytes, "roofline_ms": max(t_flops, t_bytes),
        "bound_by": "operations" if t_flops >= t_bytes else "bytes",
        "step_ms": step_ms, "step_ms_all": [ms for ms, _ in records],
        "step_over_roofline": step_ms / max(t_flops, t_bytes),
        "launches_per_step": {k: v for k, v in records[-1][1].items() if v},
        "predict_s": round(predict_s, 1), "s": round(time.perf_counter() - t_cell, 1),
    }
    log("parallel: " + json.dumps(row))
    assert PEAK_BAND[0] <= ratio <= PEAK_BAND[1], (arch, shape, ratio)
    assert peak_kernels <= PEAK_BAND[1] * mode.peak_bytes, (arch, shape, peak_kernels)
    del state
    torch.cuda.empty_cache()
    return {k: sum(got[k] for _, got in records) for k in records[0][1]}


def moe_placed_against_plain(torch, cfg, cell, state, mesh, dev):
    """The first layer's MoE on DTensors (the placed dispatch) against
    ``apply_moe`` on the same plain tensors, at the cell's width and token
    count, on a seeded input: routing, output and aux bit for bit, at the
    config's capacity factor and at half of it, where pairs are dropped
    (the dispatch's and the combine's dropped-pair branches)."""
    import dataclasses

    from repro_torch.models import moe as X
    from repro_torch.parallel import sharding as sh

    B, S = cell.global_batch, cell.seq_len
    p = sh.gather_fsdp({k: v[0] for k, v in state["params"]["blocks"]["sub0"]["moe"].items()})
    local = {k: v.to_local() for k, v in p.items()}
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(B, S, cfg.d_model, generator=g, device=dev).to(local["w_up"].dtype)
    x = sh.distribute(x, sh.to_placements(sh.batch_spec(mesh, x.shape), mesh), mesh)
    for factor in (cfg.capacity_factor, cfg.capacity_factor / 2):
        c = dataclasses.replace(cfg, capacity_factor=factor)
        with torch.no_grad():
            r, want_r = X.route(p["router"], c, x.reshape(B * S, -1)), \
                X.route(local["router"], c, x.to_local().reshape(B * S, -1))
            for field, a in r._asdict().items():
                b = getattr(want_r, field)
                same = a == b if field == "capacity" else torch.equal(a.to_local(), b)
                assert same, (field, a, b)
            dropped = int((~want_r.keep).sum())
            del r, want_r
            y, aux = X.apply_moe(p, c, x)
            want_y, want_aux = X.apply_moe(local, c, x.to_local())
            assert torch.equal(y.to_local(), want_y) and torch.equal(aux.to_local(), want_aux), (
                (y.to_local() - want_y).abs().max(), aux, want_aux)
        assert dropped > 0 or factor == cfg.capacity_factor, (factor, dropped)
        log(f"parallel: {cfg.name} placed MoE at {B} x {S} tokens, capacity factor {factor}: "
            f"routing, output {tuple(want_y.shape)} {want_y.dtype} and aux equal apply_moe's on the "
            f"plain tensors bit for bit ({dropped} of {B * S * cfg.top_k} pairs dropped at "
            f"capacity {X.moe_capacity(c, B * S)})")
        del y, aux, want_y, want_aux


def parallel_phase(torch, ops, timer, dev, dry, card_cells=True):
    """Phase 11: the dry run on the fake 16x16 mesh (``dry``, a
    BackgroundDryRuns) and the replay of its kernel calls on the card, then
    (``card_cells``) CARD_CELLS on a one-rank NCCL group (a FileStore: no
    network) and a (1, 1) cuda mesh.  Returns the replay's and each card
    cell's launches, and the replay's summary."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    results = dry.results()
    t0 = time.perf_counter()
    launches = {}
    launches["parallel/replay"], summary = replay_phase(torch, ops, timer, dev, results)
    log(f"parallel: replay in {time.perf_counter() - t0:.1f} s")
    if not card_cells:
        return launches, summary
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1),
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
            dist.all_reduce(torch.ones(1, device=dev))  # NCCL's set-up before any count
            # the cuBLAS and cuBLASLt workspaces, made at their first call and
            # kept (32 MiB, 1 MiB), before any cell counts its memory
            for dtype in (torch.float32, torch.bfloat16):
                a = torch.ones(64, 64, device=dev, dtype=dtype)
                a @ a, torch.nn.functional.linear(a, a, a[0]), torch.bmm(a[None], a[None])
            torch.cuda.synchronize()
            for arch, shape, batch, layers, opts, per_step, note in CARD_CELLS:
                launches[f"parallel {arch} {shape}"] = card_cell(
                    torch, ops, dev, mesh, arch, shape, batch, layers, opts, per_step, note)
        finally:
            dist.destroy_process_group()
    return launches, summary


# --------------------------------------------------------------------------
# phase 12: the scheduler on the card's curves
# --------------------------------------------------------------------------

# The --serve regime of benchmarks/sched_scale.py:1079-1156, restated here
# because this script imports nothing of benchmarks/ (which imports the JAX
# package's scheduler); tests/test_torch_sched.py holds the two equal.  400
# training jobs on the 16-server mixed cluster, 2 x 12 s of horizon a job,
# and one diurnal request stream of 100 requests/s with a 0.2 s SLO, served
# by up to 4 replicas of 8 GPUs at batch 8; A-SRPT runs matmul-free
# (refine_mapping=False), so that its digests hold on any machine.
SERVE_JOBS = 400
SERVE_NUM_SERVERS = 16
SERVE_SECONDS_PER_JOB = 2 * 12.0
SERVE_RATE = 100.0
SERVE_SLO = 0.2
SERVE_GPUS = 8
SERVE_MAX_REPLICAS = 4
SERVE_MAX_BATCH = 8
SERVE_TRACE = dict(seed=3, single_gpu_frac=0.3, max_gpus_per_job=32, mean_iters=400,
                   sigma_iters=1.6)
# the regime's committed digests (benchmarks/BENCH_serve_baseline.json), read as data
SERVE_BASELINE = ROOT / "benchmarks" / "BENCH_serve_baseline.json"

# The CI fleet regime of benchmarks/sched_scale.py:609-678
# (sched_scale_fleet), restated likewise (tests/test_torch_fleet.py holds
# the two equal): 64 variants, seed 0, of 300 jobs on the 16-server mixed
# cluster at 3 x 12 s of horizon a job, each variant perturbed by 3
# stragglers, 2 elastic servers and arrival jitter of sigma 60 s, under
# migrating A-SRPT without refine_mapping (matmul-free: its digests hold
# on any machine).
FLEET_VARIANTS = 64
FLEET_SEED = 0
FLEET_JOBS = 300
FLEET_NUM_SERVERS = 16
FLEET_SECONDS_PER_JOB = 3 * 12.0
FLEET_TRACE = dict(seed=1, single_gpu_frac=0.2, max_gpus_per_job=64, mean_iters=400,
                   sigma_iters=1.6, session_spread=120.0)
FLEET_BASELINE = ROOT / "benchmarks" / "BENCH_fleet_baseline.json"


def serve_regime(core, n_jobs=SERVE_JOBS, curve=None):
    """The --serve regime through the scheduler package ``core``: the
    train-only run and the mixed run (the same jobs and the request
    stream), the stream priced by ``curve`` (a ``BatchLatencyModel``) or,
    with None, by ``RequestStream``'s default curve."""
    cluster = core.mixed_cluster_spec(num_servers=SERVE_NUM_SERVERS, seed=0)
    horizon = n_jobs * SERVE_SECONDS_PER_JOB
    jobs = core.generate_trace(core.TraceConfig(n_jobs=n_jobs, horizon=horizon, **SERVE_TRACE))
    svc = {} if curve is None else {"svc_base": curve.batch_base, "svc_per_req": curve.batch_per_req}
    stream = core.RequestStream(
        stream_id=0, rate=SERVE_RATE, duration=horizon, slo=SERVE_SLO, diurnal_amplitude=0.5,
        diurnal_period=horizon, gpus=SERVE_GPUS, max_replicas=SERVE_MAX_REPLICAS,
        max_batch=SERVE_MAX_BATCH, seed=0, **svc)

    def policy():
        return core.ASRPTPolicy(core.make_predictor("mean"), tau=2.0, refine_mapping=False)

    base = core.simulate(core.Scenario(jobs=jobs, cluster=cluster), policy(), validate=False)
    mixed = core.simulate(core.Scenario(jobs=jobs, cluster=cluster, request_streams=(stream,)),
                          policy(), validate=False)
    return base, mixed


def fleet_inputs(core):
    """(base scenario, perturbations, policy factory) of the fleet regime
    through the scheduler package ``core``."""
    cluster = core.mixed_cluster_spec(num_servers=FLEET_NUM_SERVERS, seed=0)
    jobs = core.generate_trace(core.TraceConfig(
        n_jobs=FLEET_JOBS, horizon=FLEET_JOBS * FLEET_SECONDS_PER_JOB, **FLEET_TRACE))
    base = core.Scenario(jobs=tuple(jobs), cluster=cluster, name=f"fleet-base-{FLEET_JOBS}")
    perts = (core.StragglerPerturbation(n_stragglers=3), core.ElasticPerturbation(n_servers=2),
             core.ArrivalJitterPerturbation(sigma=60.0))

    def policy():
        return core.ASRPTPolicy(core.make_predictor("mean"), tau=2.0, refine_mapping=False,
                                migrate=True)

    return base, perts, policy


def fleet_regime(core):
    """The fleet regime's ``FleetResult`` through ``core``."""
    base, perts, policy = fleet_inputs(core)
    return core.run_fleet(base, policy, perts, FLEET_VARIANTS, seed=FLEET_SEED)


def serve_summary(base, mixed) -> dict:
    """What the --serve regime reports of a train-only and a mixed run."""
    return {
        "slo_attainment": mixed.slo_attainment, "n_slo_met": mixed.n_slo_met,
        "n_requests": mixed.n_requests,
        "p50_s": mixed.request_latency_percentile(50.0),
        "p99_s": mixed.request_latency_percentile(99.0),
        "train_interference": mixed.total_flow_time / base.total_flow_time,
        "n_preemptions": mixed.n_preemptions, "n_jobs": mixed.n_jobs,
        "sha256": mixed.schedule_digest(), "train_sha256": base.schedule_digest(),
    }


def sched_phase(card, curves):
    """The main path's last link: the port's scheduler core runs the CI
    fleet regime, whose 64 variant digests and fleet digest must be the
    committed ones, then the --serve regime on ``RequestStream``'s default
    curve, where its digests must be the committed ones, then on each
    curve calibrated on the card in this run (``curves``: config name ->
    ``BatchLatencyModel``).  Host work only: it launches no kernel.  An SLO that a card curve misses is
    logged, not failed: the regime is not retuned to pass."""
    import math

    from repro_torch import core

    t0 = time.perf_counter()
    fleet = fleet_regime(core)
    wall = time.perf_counter() - t0
    want = json.loads(FLEET_BASELINE.read_text())
    log("sched: " + json.dumps({"regime": "fleet", "n_variants": FLEET_VARIANTS,
                                "fleet_digest": fleet.digest(), "stats": fleet.stats,
                                "wall_s": wall, "baseline_wall_s": want["wall_s"], "card": card}))
    assert [v.digest for v in fleet.variants] == want["digests"], \
        f"the port's fleet drifted from {FLEET_BASELINE.name}"
    assert fleet.digest() == want["fleet_digest"], fleet.digest()

    want = json.loads(SERVE_BASELINE.read_text())
    want_train = next(r["train_sha256"] for r in want["rows"] if "train_sha256" in r)
    default = None
    for name, curve in {"default": None, **curves}.items():
        t0 = time.perf_counter()
        got = serve_summary(*serve_regime(core, curve=curve))
        wall = time.perf_counter() - t0
        svc = ({} if curve is None else
               {"base": curve.base, "per_req": curve.per_req,
                "tokens_per_request": curve.tokens_per_request,
                "svc_base": curve.batch_base, "svc_per_req": curve.batch_per_req})
        log("sched: " + json.dumps({"curve": name, **svc, **got, "wall_s": wall, "card": card}))
        if curve is None:
            assert (got["sha256"], got["train_sha256"]) == (want["sha256"], want_train), \
                f"the port's scheduler drifted from {SERVE_BASELINE.name}: {got}"
            assert got["n_requests"] == want["n_requests"], got
            default = got
            continue
        # the same jobs and arrivals as the default run: only the service curve differs
        assert got["train_sha256"] == default["train_sha256"], got
        assert (got["n_jobs"], got["n_requests"]) == (default["n_jobs"], default["n_requests"]), got
        assert 0.0 <= got["slo_attainment"] <= 1.0 and math.isfinite(got["p99_s"]), got
        log(f"sched: {name} on the card's curve: SLO attainment {got['slo_attainment']} "
            f"({got['n_slo_met']} of {got['n_requests']} within {SERVE_SLO} s), p99 "
            f"{got['p99_s']} s, train interference {got['train_interference']} against "
            f"{default['slo_attainment']}, {default['p99_s']} s, "
            f"{default['train_interference']} on the default curve; {card}")


def kernels_line(results, path_launches, ops, replayed):
    """The ``kernels`` line: one entry per kernel, at its main-path case,
    with its launches summed over the main paths' runs (``path_launches``:
    each path's ``_launch_counts``), by path, by route and by flash shape,
    and the summary of its replayed dry-run calls (``replayed``)."""
    total = {}
    for counts in path_launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    flash_routes = {r: total[f"flash/{r}"] for r in ops.FLASH_ROUTES}
    flash_shapes = _flash_shapes(total)
    ssd_routes = {r: total[f"ssd/{r}"] for r in ops.SSD_ROUTES}
    line = []
    for name, source, replaces, chosen in (
        ("rmsnorm", "src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:24",
         "bfloat16 rows=8 D=4096"),
        ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention.py:87", "decode bfloat16 B=8"),
        ("ssd_scan", "src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:98",
         "prefill bfloat16 B=1 S=512 H=32 P=64 N=128 chunk=128 y=float32"),
    ):
        mine = [r for r in results if r["kernel"] == name]
        rep = next(r for r in mine if r["case"].startswith(chosen))
        by_path = {arch: counts[name] for arch, counts in path_launches.items()}
        assert sum(by_path.values()) > 0, f"{name} was not launched on its path"
        line.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            **({"launches_by_flash_route": flash_routes,
                "launches_by_flash_shape": flash_shapes} if name == "flash_attention" else {}),
            **({"launches_by_ssd_route": ssd_routes} if name == "ssd_scan" else {}),
            replayed_dry_run_calls=replayed[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"], case=rep["case"],
        ))
    return line


# --------------------------------------------------------------------------


def parse_args(argv):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="",
                    help="comma list of rmsnorm, flash, flash_bwd, ssd, prefill_profile, jamba, "
                         "replay, parallel, sched: run the device and build phases and these, then stop "
                         "(to time another tree's kernels beside this one's in one chip call, or "
                         "phase 10c, phase 11's dry run and replay, phase 11 or phase 12 alone)")
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="root of the checkout whose src/repro_torch is run (default: this one)")
    args = ap.parse_args(argv)
    args.only = [p for p in args.only.split(",") if p]
    unknown = set(args.only) - {"rmsnorm", "flash", "flash_bwd", "ssd", "prefill_profile", "jamba",
                                "replay", "parallel", "sched"}
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    return args


def main(argv=None) -> int:
    import torch

    args = parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(args.src.resolve() / "src"))
    # phase 11's dry runs, on the host from here on, beside the card phases
    dry = BackgroundDryRuns() if not args.only or {"replay", "parallel"} & set(args.only) else None
    try:
        return run_phases(torch, args, dry)
    finally:
        if dry is not None:
            dry.close()


def run_phases(torch, args, dry) -> int:
    """Phases 1-12 (or those ``args.only`` names); ``dry``: the dry runs
    phase 11 collects."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    dev = torch.device("cuda", 0)
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        print(f"chip_smoke: needs a Hopper card (capability 9.0), got {cap}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path().name})")

    # 3. kernels against their plain versions
    timer = Timer(torch, dev)
    results = []
    for name, cases in (("rmsnorm", rmsnorm_cases), ("flash", flash_cases),
                        ("flash_bwd", flash_bwd_cases), ("ssd", ssd_cases)):
        if not args.only or name in args.only:
            results += cases(torch, ops, ref, timer, dev)
    for r in results:
        log("case: " + json.dumps(r))
    bad = [r["case"] for r in results if not r["ok"]]
    assert not bad, f"kernels disagree with their plain versions: {bad}"
    if args.only:
        if "prefill_profile" in args.only:
            cfg = get_config("mamba2-370m")
            profile_prefill(torch, np, cfg, init_params(torch, Model, cfg, dev))
        if "jamba" in args.only:
            jamba_phase(torch, np, ops, dev)
        if "replay" in args.only or "parallel" in args.only:
            parallel_phase(torch, ops, timer, dev, dry, card_cells="parallel" in args.only)
        if "sched" in args.only:
            cfg = get_config("deepseek-7b")
            curves = {cfg.name: calibrate_phase(cfg, init_params(torch, Model, cfg, dev), card)}
            curves["deepseek-7b reduced"] = reduced_curve_phase(torch, ops, dev, card)[1]
            sched_phase(card, curves)
        log(f"only {args.only} from {args.src}: done in {time.perf_counter() - t_start:.1f} s")
        return 0

    laps = [t_start]

    def lap(phase):  # the wall time of the phase that just ended
        laps.append(time.perf_counter())
        log(f"phase {phase}: {laps[-1] - laps[-2]:.1f} s")

    lap("1-3")
    # 4. serve deepseek-7b at full width (main path 1)
    cfg = get_config("deepseek-7b")
    params = init_params(torch, Model, cfg, dev)
    n = cfg.n_layers
    path_launches = {}  # the launches (_launch_counts) of each main path's run
    path_launches[cfg.name] = serve(
        torch, np, cfg, params, ops, lengths=SERVE_PROMPTS,
        per_pass={"rmsnorm": (2 * n + 1,) * 2, "flash_attention": (n, n), "ssd_scan": (0, 0)},
        routes={"flash_attention": {"prefill": "mma_prefill", "decode": "decode"}},
    )

    lap("4")
    # 5. checks
    dense_consistency(torch, np, cfg, params)
    small_model_against_cpu(torch, np, ops)

    lap("5")
    # 6. where a decode step's time goes, and the calibrated curve
    profile_decode(torch, cfg, params)
    curves = {cfg.name: calibrate_phase(cfg, params, card)}
    del params
    torch.cuda.empty_cache()
    # the reference's default curve's own config, calibrated on the card
    path_launches["deepseek-7b/reduced curve"], curves["deepseek-7b reduced"] = \
        reduced_curve_phase(torch, ops, dev, card)

    lap("6")
    # 7. serve mamba2-370m at full width (main path 2), and its checks
    cfg = get_config("mamba2-370m")
    params = init_params(torch, Model, cfg, dev)
    n = cfg.n_layers
    # per pass: ln1 and the gated norm in every layer plus the final norm
    # (97); one SSD scan per layer on prefill, none on decode
    # every scan on the tensor-core route (bf16, aligned xBC views)
    path_launches[cfg.name] = serve(
        torch, np, cfg, params, ops, lengths=[1, 2, 5, 83, 200, 300],
        per_pass={"rmsnorm": (2 * n + 1,) * 2, "flash_attention": (0, 0), "ssd_scan": (n, 0)},
        routes={"ssd_scan": {"prefill": "mma", "decode": "mma"}},
    )
    ssm_prefill_decode_consistency(torch, np, cfg, params)
    small_ssm_against_cpu(torch, np, ops)
    profile_decode(torch, cfg, params)
    profile_prefill(torch, np, cfg, params)
    del params
    torch.cuda.empty_cache()

    lap("7")
    # 8. serve qwen3-moe-30b-a3b, then moonshot-v1-16b-a3b, at full width (main
    # path 5), and their checks
    moe_counts, curves["qwen3-moe-30b-a3b"] = moe_phase(torch, np, ops, dev, card)
    path_launches.update(moe_counts)

    lap("8")
    # 9. training (main paths 3 and 4), and its checks
    path_launches["deepseek-7b/train"] = train_cut(torch, ops, dev, "deepseek-7b", 8)
    torch.cuda.empty_cache()
    path_launches["qwen3-moe-30b-a3b/train"] = train_cut(torch, ops, dev, "qwen3-moe-30b-a3b", 4)
    torch.cuda.empty_cache()
    path_launches["mamba2-370m/train"] = train_mamba(torch, ops)
    torch.cuda.empty_cache()
    small_train_against_cpu(torch, ops)
    resume_on_card(torch)

    lap("9")
    # 10. the vlm, audio, sliding-window and hybrid families (main paths 6-8, and
    # the hybrid cut to its reduced config)
    path_launches["llava-next-mistral-7b"] = vlm_phase(torch, np, ops, dev)
    torch.cuda.empty_cache()
    path_launches["hubert-xlarge"], path_launches["hubert-xlarge/train"] = \
        audio_phase(torch, np, ops, dev)
    torch.cuda.empty_cache()
    path_launches["h2o-danube-3-4b"] = swa_phase(torch, np, ops, dev)
    torch.cuda.empty_cache()
    path_launches["jamba-1.5-large-398b/reduced"] = hybrid_phase(torch, np, ops)
    torch.cuda.empty_cache()

    lap("10")
    # 10b. qwen3-32b and granite-34b at full width (main path 1 on the dense giants)
    path_launches.update(dense_giants_phase(torch, np, ops, dev))

    lap("10b")
    # 10c. jamba-1.5-large-398b at its own widths, cut to one super-block, and
    # at a mid width in bf16 and fp32
    path_launches.update(jamba_phase(torch, np, ops, dev))

    lap("10c")
    # 11. the parallel and launch layer: the dry run, the replay of its kernel
    # calls, and its cells on the card
    parallel_launches, replayed = parallel_phase(torch, ops, timer, dev, dry)
    path_launches.update(parallel_launches)

    lap("11")
    # 12. the scheduler on the default curve, then on the curves of phases 6 and 8
    sched_phase(card, curves)

    lap("12")
    line = kernels_line(results, path_launches, ops, replayed)
    log(f"total: {time.perf_counter() - t_start:.1f} s, phase 11 {laps[-2] - laps[-3]:.1f} s, on {card}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def init_params(torch, Model, cfg, dev):
    from repro_torch.models.model import n_params

    held = torch.cuda.memory_allocated()  # what earlier phases left: should be near 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"init: {cfg.name} {cfg.n_layers} layers, {n_params(params)} params in {cfg.dtype}, "
        f"{time.perf_counter() - t0:.1f} s; memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, held before {held / 2**30:.2f} GiB")
    return params


if __name__ == "__main__":
    sys.exit(main())
