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
  4. serve    — main path 1: full-width, 30-layer deepseek-7b in bf16 from
                a seeded generator; ServeEngine(max_len=512, batch_size=4)
                serves 6 requests of 16 new tokens; every forward pass must
                launch 61 RMSNorm and 30 attention kernels, a prefill's
                through the tensor-core route (mma_prefill), a decode
                step's through the decode route.
  5. checks   — prefill/decode consistency at full width, and a small model
                on the card against the same model on the CPU (plain path);
                in fp32 its prefill takes the FMA route and its decode
                steps the decode route.
  6. calibrate — a profiled decode step (device busy share, time by kernel)
                and the decode-step latency curve at batch 1, 8, 32, 128.
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
                calibrated curve.
  9. train    — main path 3: deepseek-7b at full width, depth cut to 8
                layers (fp32 AdamW moments for 30 would not fit), bf16,
                3 steps of make_train_step at batch 4 x seq 512; every step
                launches 33 RMSNorm and 16 attention kernels (forward and
                the remat recompute), all on mma_prefill; a profiled step.
                Main path 4: mamba2-370m at full width and depth through
                train_loop, 4 steps at batch 8 x seq 512; every step 193
                RMSNorm and 96 SSD scans, all on mma.  Finite losses and
                grad norms, the step-0 loss near its expected value; small
                models trained on the card against the CPU; a failed and
                resumed train_loop against a straight run.
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
                reduced config at head_dim 64 in fp32: prefill and decode
                on the card against the CPU (the same routing), then
                ServeEngine, its tokens against the CPU engine's.
 11. parallel — the dry run (repro_torch.launch.dryrun) of one shape per
                arch on a fake 16x16 mesh (256 ranks), a line per cell:
                fits_h100, the per-device peak, FLOPs, collective bytes, the
                bottleneck.  Then, on a one-rank NCCL group and a (1, 1) cuda
                mesh, with params, state, cache and batch as DTensors placed
                by the sharding rules, six cells against their dry run on
                the meta device at the same cut: mamba2-370m and
                h2o-danube-3-4b at long_500k (one decode step, uncut),
                deepseek-7b at decode_32k (batch 2), mamba2-370m at train_4k
                (batch 8: loss, grads, AdamW), deepseek-7b at train_4k
                (batch 2, 8 layers) and qwen3-moe-30b-a3b at decode_32k
                (batch 2) under moe_a2a, whose logits must equal apply_moe's
                bit for bit.  In one step of each cell every kernel call
                is held against its plain version on the same inputs (row
                error within PLAIN_TOL; a decode cache drawn at random), and
                phase 3 holds each kernel at these cells' shapes.  Each
                holds the state's bytes
                (requested exactly; allocated within the allocator's
                rounding), the step's peak (measured / predicted in
                PEAK_BAND), FLOPs and roofline time against the median of 5
                steps, and every step's launches by kernel, route, head dim
                and mask, all through the wrappers' DTensor branch.
Then one line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

    python3 chip_smoke.py --only rmsnorm,ssd,prefill_profile --src DIR

runs phases 1-3 for the named kernels (and the profiled prefill, or phase
11 for "parallel") on the port in DIR/src, then stops: two trees' kernels
timed in one chip call.

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
        # (8 x 500 frames of 1280), h2o-danube-3-4b's 8192-token prefill (3840)
        ("bfloat16", 4000, 1280), ("bfloat16", 8192, 3840),
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
        esize = x.element_size()
        b_ms, b_by = bound(rows * D * 2 * esize + 4 * D, 4 * rows * D, "float32")
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
        # deepseek-7b and qwen3-moe-30b-a3b x decode_32k at batch 2 (phase 11)
        ("decode_32k", 2, 1, 32768, 32, 32, 128, "bfloat16", None, last_q, full_kv, True),
        ("decode_32k_moe", 2, 1, 32768, 32, 4, 128, "bfloat16", None, last_q, full_kv, True),
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

        mask = ref.attention_mask(qpos, kvpos, causal, window)  # [Sq,T] or [B,Sq,T]
        # the work this data needs: visible pairs, and every key for a row
        # that sees none (it averages v over all T keys)
        mask_b = mask.expand(B, Sq, T)
        mask_b = mask_b | ~mask_b.any(dim=-1, keepdim=True)
        pairs = int(mask_b.sum())
        keys_needed = int(mask_b.any(dim=1).sum())  # per batch row, union over queries
        esize = q.element_size()
        moved = (2 * q.numel() * esize + 2 * keys_needed * G * K * esize
                 + 4 * (qpos.numel() + kvpos.numel()))
        b_ms, b_by = bound(moved, 4 * K * H * pairs, dtype)
        lib_ms = None
        if name != "fully_masked":  # SDPA gives NaN for a row with no key
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


def ssd_cases(torch, ops, ref, timer, dev):
    from repro_torch.launch.cost import ssd_flops

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
    ]
    gen = torch.Generator(device=dev).manual_seed(5)
    out = []
    for name, B, S, H, P, N, Q, dtype, ydtype in cases:
        tdt, ydt = getattr(torch, dtype), getattr(torch, ydtype)
        x = torch.randn(B, S, H, P, generator=gen, device=dev).to(tdt)
        dt = torch.rand(B, S, H, generator=gen, device=dev) * 0.099 + 0.001
        A = -(torch.rand(H, generator=gen, device=dev) * 3.5 + 0.5)
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
        S_run = S - lo
        esize, ysize = x.element_size(), y.element_size()
        moved = (B * S_run * H * P * (esize + ysize) + 4 * B * S_run * H + 4 * H
                 + 2 * B * S_run * N * esize + 4 * B * H * N * P * (2 if init is not None else 1))
        b_ms, b_by = bound(moved, ssd_flops(B, S_run, H, P, N, Q), dtype)  # launch/cost.py
        out.append(dict(
            kernel="ssd_scan",
            case=f"{name} {dtype} B={B} S={S_run} H={H} P={P} N={N} chunk={Q} y={ydtype}"
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

    engine._logits_to_host = checked
    engine.generate([Request(99, [1, 2, 3, 4, 5, 6, 7, 8], max_new_tokens=2)])  # warm-up

    passes = []  # (kind, launches of that pass, its launches by route)
    model = engine.model

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


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def prefill_decode_consistency(torch, np, cfg, params):
    """prefill(p[:n+1]) against prefill(p[:n]) + decode_step(p[n], pos=n),
    two rows at different depths decoded in one batch with per-row pos."""
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
    ns = [37, 120]
    prompts = [rng.integers(0, cfg.vocab_size, n + 1).tolist() for n in ns]
    cache = model.init_cache(2, 512)
    full = []
    for row, (p, n) in enumerate(zip(prompts, ns)):
        tok = torch.tensor([p], dtype=torch.int32, device=dev)
        full.append(model.prefill(params, {"tokens": tok})[0][0, 0])
        _, rc = model.prefill(params, {"tokens": tok[:, :n]}, model.init_cache(1, 512))
        ServeEngine.insert_row(cache, rc, row)
    last = torch.tensor([[p[n]] for p, n in zip(prompts, ns)], dtype=torch.int32, device=dev)
    dec, _ = model.decode_step(params, cache, last, torch.tensor(ns, dtype=torch.int32, device=dev))
    errs = [rel_err(dec[i, 0], full[i]) for i in range(2)]
    control = rel_err(dec[1, 0], full[0])  # another row's context: what a fault looks like
    log(f"consistency: rel L2 err of decode vs prefill logits {errs} (tol {tol}); "
        f"control (row 1's decode vs row 0's prefill) {control:.4f}")
    assert all(torch.isfinite(d).all() for d in full) and bool(torch.isfinite(dec).all())
    assert max(errs) <= tol, errs


def small_model_against_cpu(torch, np, ops):
    """A small model (head_dim 64, fp32) on the card through the kernels
    against the same weights on the CPU through the plain versions."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import Model

    tol = 1e-4
    cfg = reduced_config("deepseek-7b", head_dim=64)
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

    before = dict(ops.FLASH_ROUTES)
    out_gpu = run(gpu, p_gpu)
    routes = {r: ops.FLASH_ROUTES[r] - before[r] for r in before}
    # fp32: the prefill takes the FMA route, the decode steps the decode route
    want = {"decode": 4 * cfg.n_layers, "mma_prefill": 0, "fma": cfg.n_layers}
    assert routes == want, (routes, want)
    worst = max((a - b).abs().max().item() for a, b in zip(out_gpu, run(cpu, p_cpu)))
    log(f"small model: cuda kernels vs cpu plain path, prefill + 4 decode steps, "
        f"max abs logit err {worst:.3e} (tol {tol}); flash by route {routes}")
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


def calibrate_phase(cfg, params, card):
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.latency import calibrate

    engine = ServeEngine(cfg, params, max_len=64, batch_size=128)
    t0 = time.perf_counter()
    curve = calibrate(engine, batch_sizes=(1, 8, 32, 128), steps=24)
    log(f"calibrate: {card}; {cfg.name} full width bf16, max_len 64, batch sizes "
        f"(1, 8, 32, 128), 24 steps each: base {curve.base!r} s, per_req {curve.per_req!r} s "
        f"({time.perf_counter() - t0:.1f} s); step_time(b) ms: "
        + ", ".join(f"{b}: {curve.step_time(b) * 1e3:.3f}" for b in (1, 8, 32, 128)))


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
        if any(w in key for w in ("w_up", "w_gate", "w_down")):
            expert += size
    return expert, step


def serve_moe(torch, np, cfg, params, ops, lengths):
    """serve() with every routing call recorded: each prefill's dropped
    (token, k) pairs, layer by layer."""
    n = cfg.n_layers
    with RouteLog() as rl:
        counts = serve(
            torch, np, cfg, params, ops, lengths=lengths,
            per_pass={"rmsnorm": (4 * n + 1,) * 2, "flash_attention": (n, n), "ssd_scan": (0, 0)},
            routes={"flash_attention": {"prefill": "mma_prefill", "decode": "decode"}},
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
            f"(token, k) pairs a layer; dropped {sum(dropped)} over {n} layers "
            f"({sum(dropped) / (n * T * cfg.top_k):.4f}), by layer {dropped}; experts chosen "
            f"by any pair a layer: min {used[0]}, median {used[n // 2]}, max {used[-1]} of "
            f"{cfg.n_experts}; largest load {max(int(r.load.max()) for r in ps)} pairs")
    decode_dropped = sum(int((~r.keep).sum()) for ps, T in zip(passes[2:], tokens[2:]) if T == 4
                         for r in ps)
    log(f"serve {cfg.name}: decode steps dropped {decode_dropped} pairs (capacity 8, 4 rows)")
    assert decode_dropped == 0, decode_dropped
    return counts


def small_moe_against_cpu(torch, np, ops):
    """Reduced qwen3-moe-30b-a3b (head_dim 64, fp32) on the card through
    the kernels against the same weights on the CPU through the plain
    versions: a prefill of 3 x 12 tokens and 4 decode steps at per-row
    positions, at capacity_factor 0.5, where the prefill drops pairs.  The
    logits within 1e-4, and every routing call picks the same experts and
    drops the same pairs on both."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import Model

    tol = 1e-4
    cfg = dataclasses.replace(reduced_config("qwen3-moe-30b-a3b", head_dim=64), capacity_factor=0.5)
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
        return outs, [(r.capacity, r.top_i.cpu(), r.keep.cpu()) for r in rl.records]

    n0 = dict(ops.LAUNCHES)
    out_gpu, r_gpu = run(gpu, p_gpu)
    launches = {k: ops.LAUNCHES[k] - n0[k] for k in n0}
    out_cpu, r_cpu = run(cpu, p_cpu)
    worst = max((a - b).abs().max().item() for a, b in zip(out_gpu, out_cpu))
    same = len(r_gpu) == len(r_cpu) == 5 * cfg.n_layers and all(
        a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
        for a, b in zip(r_gpu, r_cpu))
    dropped = sum(int((~keep).sum()) for *_, keep in r_gpu)
    log(f"small moe model: cuda kernels vs cpu plain path, prefill 3 x 12 + 4 decode steps, "
        f"capacity_factor 0.5: max abs logit err {worst:.3e} (tol {tol}); the same experts and "
        f"dropped pairs in all {len(r_gpu)} routing calls: {same}; {dropped} pairs dropped "
        f"(prefill capacity {r_gpu[0][0]}); launches {launches}")
    L = cfg.n_layers
    assert launches == {"rmsnorm": 5 * (4 * L + 1), "flash_attention": 5 * L, "ssd_scan": 0}, launches
    assert same and dropped > 0 and worst <= tol, (same, dropped, worst)


def moe_phase(torch, np, ops, dev, card):
    """Main path 5 and its checks.  Returns its launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config("qwen3-moe-30b-a3b")
    params = init_params(torch, Model, cfg, dev)
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    log(f"init {cfg.name}: KV cache {kv / 1024:.0f} KiB a token, "
        f"{4 * 512 * kv / 2**20:.0f} MiB at batch 4 x 512")
    counts = serve_moe(torch, np, cfg, params, ops, lengths=[200, 5, 83, 161, 44, 122])
    # C >= T K for every prompt: a prefill drops no pair, as decode never does
    prefill_decode_consistency(
        torch, np, dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts)), params)
    small_moe_against_cpu(torch, np, ops)
    profile_decode(torch, cfg, params, bounds=moe_weight_bytes(cfg, params, 4))
    calibrate_phase(cfg, params, card)
    return counts


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
    records.append(dict(wall=wall, loss=float(metrics["loss"]),
                        grad_norm=float(metrics["grad_norm"]),
                        launches=_diff(_launch_counts(ops), before)))
    return state, metrics


def check_train_records(cfg, records, per_step, tokens_per_step, label):
    """Finite losses and grad norms, the step-0 loss near its expected
    value, and the launches of every step as predicted."""
    import math

    want0 = expected_first_loss(cfg)
    ln_v = math.log(cfg.padded_vocab)
    for i, r in enumerate(records):
        log(f"{label}: step {i} loss {r['loss']!r} grad_norm {r['grad_norm']!r} wall "
            f"{r['wall'] * 1e3:.3f} ms = {tokens_per_step / r['wall']:.1f} tokens/s; launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }")
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records), records
    loss0 = records[0]["loss"]
    log(f"{label}: step-0 loss {loss0!r}: ln(V) = {ln_v!r} (distance {loss0 - ln_v:+.4f}), expected "
        f"ln(V) + s^2/2 = {want0!r} (distance {loss0 - want0:+.4f}, tol 0.5)")
    assert abs(loss0 - want0) <= 0.5, (loss0, want0)
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


def train_deepseek(torch, ops, dev, steps: int = 3):
    """Main path 3: deepseek-7b at full width, depth cut to 8 layers (the
    reference's fp32 AdamW moments for all 30 would not fit in 80 GB),
    bf16, batch 4 x seq 512 from DataLoader(seed=0), make_train_step on
    init_train_state.  Returns its launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import n_params
    from repro_torch.train.data import DataLoader
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = dataclasses.replace(get_config("deepseek-7b"), n_layers=8)
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated() / 2**30
    log(f"train deepseek-7b: {cfg.n_layers} layers, {n_params(state.params)} params, state "
        f"{state_gib:.2f} GiB (bf16 params, fp32 m and v), init {time.perf_counter() - t0:.1f} s")
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=100)
    step_fn = make_train_step(model, opt_cfg)
    loader = DataLoader(cfg, 4, 512, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in loader.next().items()}
               for _ in range(steps + 1)]
    L = cfg.n_layers
    records = []
    ops.reset_launches()
    for batch in batches[:steps]:
        state, _ = timed_step(torch, ops, step_fn, state, batch, records)
    counts = _launch_counts(ops)
    launches, flash_routes = dict(ops.LAUNCHES), dict(ops.FLASH_ROUTES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_train_records(cfg, records, {"rmsnorm": 4 * L + 1, "flash_attention": 2 * L,
                                       "flash/mma_prefill": 2 * L,
                                       f"flash/mma_prefill K={cfg.head_dim} causal": 2 * L},
                        4 * 512, "train deepseek-7b")
    walls = sorted(r["wall"] for r in records[1:])
    log(f"train deepseek-7b: {steps} steps at batch 4 x seq 512; step wall after the first "
        f"{[round(w * 1e3, 3) for w in walls]} ms, {4 * 512 / walls[0]:.1f} tokens/s at the best; "
        f"peak memory {peak:.2f} GiB; launches {launches}, flash by route {flash_routes}")
    profile_train_step(torch, model, opt_cfg, step_fn, state, batches[steps], "train deepseek-7b")
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
    """Small float32 models (reduced deepseek-7b at head_dim 64, reduced
    mamba2-370m) trained on the card through the kernels and on the CPU
    through the plain versions, from the same weights and batches.  Losses
    within 1e-5 relative at every step.  Params: an Adam step is about
    +-lr wherever the gradient is tiny, so an element whose gradient is
    within float noise of 0 may step the other way on the other device;
    none may differ by more than 2 sum(lr), and at most a 1e-3 share of a
    leaf's elements by more than 1e-5."""
    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models import Model
    from repro_torch.train.data import DataLoader
    from repro_torch.train.optimizer import AdamWConfig, cosine_lr
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import leaves_with_paths, tree_map

    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=2, total_steps=10)
    bound = 2 * sum(float(cosine_lr(opt, torch.tensor(s + 1))) for s in range(steps))
    for arch, kw in (("deepseek-7b", {"head_dim": 64}), ("mamba2-370m", {})):
        cfg = reduced_config(arch, **kw)
        cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
        s_cpu = init_train_state(cpu, torch.Generator().manual_seed(11))
        # a copy: the steps update each state's tensors in place
        s_gpu = tree_map(lambda t: t.to(gpu.device, copy=True), s_cpu)
        f_cpu, f_gpu = make_train_step(cpu, opt), make_train_step(gpu, opt)
        loader = DataLoader(cfg, 4, 40, seed=0)
        loss_err, launches = 0.0, {}
        for _ in range(steps):
            batch = {k: torch.from_numpy(v) for k, v in loader.next().items()}
            s_cpu, m_cpu = f_cpu(s_cpu, batch)
            before = _launch_counts(ops)
            s_gpu, m_gpu = f_gpu(s_gpu, {k: v.to(gpu.device) for k, v in batch.items()})
            for k, v in _diff(_launch_counts(ops), before).items():
                if v:
                    launches[k] = launches.get(k, 0) + v
            lc, lg = float(m_cpu["loss"]), float(m_gpu["loss"])
            loss_err = max(loss_err, abs(lg - lc) / abs(lc))
        want = dict(leaves_with_paths(s_cpu.params))
        worst, share = 0.0, 0.0
        for key, p in leaves_with_paths(s_gpu.params):
            err = (p.cpu() - want[key]).abs().numpy()
            worst, share = max(worst, float(err.max())), max(share, float(np.mean(err > 1e-5)))
        log(f"small train {arch}: {steps} steps, card kernels vs cpu plain path: worst loss rel err "
            f"{loss_err:.3e} (tol 1e-5); params worst abs err {worst:.3e} (bound {bound:.3e}), "
            f"largest share of a leaf off by > 1e-5 {share:.2e} (tol 1e-3); launches {launches}")
        L = cfg.n_layers
        mixer = {"deepseek-7b": ("flash_attention", "flash/fma", "flash/fma K=64 causal"),
                 "mamba2-370m": ("ssd_scan", "ssd/fma")}
        assert launches == {"rmsnorm": steps * (4 * L + 1),
                            **{k: steps * 2 * L for k in mixer[arch]}}, launches
        assert loss_err <= 1e-5 and worst <= bound and share <= 1e-3, (loss_err, worst, share)


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
    walls = sorted(r["wall"] for r in records[1:])
    log(f"train {cfg.name}: 3 steps at batch {B} x {S} frames ({labels} masked-frame labels in "
        f"all); step wall after the first {[round(w * 1e3, 3) for w in walls]} ms; peak memory "
        f"{peak:.2f} GiB; launches {dict(ops.LAUNCHES)}, flash by shape {dict(ops.FLASH_SHAPES)}")
    profile_calls(torch, f"{cfg.name} prefill {B} x {S}", lambda: model.prefill(state.params, frames))
    profile_train_step(torch, model, opt_cfg, step_fn, state, batches[3], f"train {cfg.name}")
    return prefill_counts, train_counts


def kernels_against_plain(torch, ops, model, params, inputs, label, tol=5e-2):
    """Last-position logits of one prefill through the kernels against the
    same prefill with the wrappers swapped for their plain versions, on
    the card, in the model's type (relative L2 <= tol)."""
    from repro_torch.kernels import ref

    got = model.prefill(params, inputs)[0].float()
    saved = ops.rmsnorm, ops.flash_attention
    ops.rmsnorm, ops.flash_attention = ref.rmsnorm_ref, ref.flash_attention_ref
    try:
        n = dict(ops.LAUNCHES)
        want = model.prefill(params, inputs)[0].float()
        assert ops.LAUNCHES == n, "a kernel ran in the plain pass"
    finally:
        ops.rmsnorm, ops.flash_attention = saved
    err = rel_err(got, want)
    log(f"{label}: logits through the kernels against the plain versions on the card, rel L2 "
        f"{err:.3e} (tol {tol})")
    assert bool(torch.isfinite(got).all()) and err <= tol, err


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


def hybrid_phase(torch, np, ops):
    """The hybrid family on the card, cut: reduced jamba-1.5-large-398b
    (two super-blocks of 8 layers: attention at the 5th, Mamba elsewhere,
    MoE on every 2nd) at head_dim 64, fp32.  Prefill of 2 x 12 tokens and
    4 decode steps at per-row positions on the card against the CPU
    (logits within 1e-4, the same experts and dropped pairs in every
    routing call); then ServeEngine serves prompts of 3 or more tokens on
    the card, every pass's launches counted, with the CPU engine's tokens.
    Returns the served run's launches."""
    import dataclasses

    from repro_torch.configs import reduced_config
    from repro_torch.models import Model
    from repro_torch.serve.engine import Request, ServeEngine

    tol = 1e-4
    cfg = reduced_config("jamba-1.5-large-398b", head_dim=64)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg)
    p_cpu = cpu.init(torch.Generator().manual_seed(16))
    p_gpu = _tree_to(p_cpu, gpu.device)
    toks = torch.from_numpy(np.random.default_rng(17).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))

    def run(model, params):
        dev = model.device
        cache = model.init_cache(2, 32)
        with RouteLog() as rl:
            outs = [model.prefill(params, {"tokens": toks[:, :12].to(dev)}, cache)[0].cpu()]
            for i in range(4):
                pos = torch.tensor([12 + i, 12 + i], dtype=torch.int32, device=dev)
                outs.append(model.decode_step(params, cache, toks[:, 12 + i : 13 + i].to(dev), pos)[0].cpu())
        return outs, [(r.capacity, r.top_i.cpu(), r.keep.cpu()) for r in rl.records]

    out_gpu, r_gpu = run(gpu, p_gpu)
    out_cpu, r_cpu = run(cpu, p_cpu)
    worst = max((a - b).abs().max().item() for a, b in zip(out_gpu, out_cpu))
    moe_layers = sum(f == "moe" for _, f in cfg.layer_kinds()) * cfg.n_scan_blocks
    same = len(r_gpu) == len(r_cpu) == 5 * moe_layers and all(
        a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
        for a, b in zip(r_gpu, r_cpu))
    dropped = sum(int((~keep).sum()) for *_, keep in r_gpu)
    log(f"hybrid {cfg.name} (reduced, head_dim 64, fp32): card kernels vs cpu plain path, prefill "
        f"2 x 12 + 4 decode steps: max abs logit err {worst:.3e} (tol {tol}); the same experts and "
        f"dropped pairs in all {len(r_gpu)} routing calls: {same} ({dropped} pairs dropped)")
    assert same and worst <= tol, (same, worst)

    nb = cfg.n_scan_blocks
    kinds = cfg.layer_kinds()
    n_attn = nb * sum(m == "attn" for m, _ in kinds)
    n_mamba = nb * sum(m == "mamba" for m, _ in kinds)
    # every sub-layer has ln1 and ln2 (dense or MoE ff); a Mamba layer adds
    # its gated norm
    norms = 2 * cfg.n_layers + n_mamba + 1
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
# phase 11: the parallel and launch layer
# --------------------------------------------------------------------------

# The dry run of one shape per arch on the fake 16x16 mesh (all 32 cells
# take about 160 s of host time: python -m repro_torch.launch.dryrun --all
# writes them).
DRYRUN_CELLS = (
    ("deepseek-7b", "decode_32k"), ("granite-34b", "decode_32k"),
    ("h2o-danube-3-4b", "long_500k"), ("hubert-xlarge", "prefill_32k"),
    ("jamba-1.5-large-398b", "long_500k"), ("llava-next-mistral-7b", "decode_32k"),
    ("mamba2-370m", "long_500k"), ("moonshot-v1-16b-a3b", "decode_32k"),
    ("qwen3-32b", "prefill_32k"), ("qwen3-moe-30b-a3b", "decode_32k"),
)
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
)
# measured / predicted per-device peak of a step: PERF.md's first
# prediction set 0.97-1.15; the first runs read 0.9999994-1.00025 in every
# cell, so the band is held at that reading's width
PEAK_BAND = (0.999, 1.01)
# a kernel call's worst row relative L2 against its plain version on the
# same inputs (the flash cases' bf16 row tolerance)
PLAIN_TOL = 1e-2
SEGMENT = 2 << 20  # the caching allocator's large segments are whole 2 MiB


def dryrun_cells(torch):
    """The dry run of DRYRUN_CELLS, each on a fake group of 256 made and
    destroyed by run_cell; one line each."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    for arch, shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        r = dryrun.run_cell(arch, shape, False, verbose=False)
        assert r["ok"] and not dist.is_initialized(), r
        keys = ("fits_h100", "peak_memory_bytes", "state_bytes", "flops", "bytes",
                "coll_bytes", "coll_breakdown", "model_flops", "bottleneck", "kernel_calls")
        log("dryrun: " + json.dumps({"cell": f"{arch} x {shape} x 16x16",
                                     "s": round(time.perf_counter() - t0, 1),
                                     **{k: r[k] for k in keys}}))


class CallsAgainstPlain:
    """While installed, every kernel wrapper call that comes as DTensors
    runs as it would (``local_map`` to the kernel) and, beside it, the
    kernel's plain version on the same local inputs; each kernel's worst
    row error (``rel_rows``) and its calls are kept.  Plain-tensor calls
    (the wrappers' own, inside ``local_map``) pass as they are."""

    KEEP = {"rmsnorm": -1, "flash_attention": 2, "ssd_scan": 2}  # row dims, per output

    def __init__(self, torch, ops):
        from repro_torch.kernels import ref

        def ssd_plain(x, dt, A, Bm, Cm, chunk, init_state=None, out_dtype=torch.float32):
            y, state = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk, init_state)
            return y.to(out_dtype), state

        self.torch, self.ops = torch, ops
        self.plain = {"rmsnorm": ref.rmsnorm_ref, "flash_attention": ref.flash_attention_ref,
                      "ssd_scan": ssd_plain}
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


def card_cell(torch, ops, dev, mesh, arch, shape, batch, layers, opts, per_step, note, steps=5):
    """One dry-run cell on the card, against its dry run on the meta device
    with the same mesh and cut: the state's bytes (exact), the step's peak
    (in PEAK_BAND), FLOPs and roofline time against the step's median
    device time, and every step's launches by kernel, route and shape, all
    through the wrappers' DTensor branch; and one step's every kernel call
    against its plain version on the same inputs.  Returns the launches
    of the timed steps."""
    import dataclasses
    import gc

    from torch.distributed.tensor import DTensor

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import analysis, dryrun
    from repro_torch.models import Model
    from repro_torch.parallel import opt_flags
    from repro_torch.tree import leaves

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
        out = dryrun.run_step(model, cell, state)  # the step the peak is read on
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - a0
        first = out[0] if cell.kind != "train" else out[1]["loss"]
        assert isinstance(first, DTensor) and bool(first.to_local().float().isfinite().all())
        del out, first
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
        "peak_bytes": {"predicted": mode.peak_bytes, "measured": peak, "ratio": ratio},
        "flops": mode.flops, "bytes": mode.bytes, "roofline_ms": max(t_flops, t_bytes),
        "bound_by": "operations" if t_flops >= t_bytes else "bytes",
        "step_ms": step_ms, "step_ms_all": [ms for ms, _ in records],
        "step_over_roofline": step_ms / max(t_flops, t_bytes),
        "launches_per_step": {k: v for k, v in records[-1][1].items() if v},
        "predict_s": round(predict_s, 1),
    }
    log("parallel: " + json.dumps(row))
    assert PEAK_BAND[0] <= ratio <= PEAK_BAND[1], (arch, shape, ratio)
    del state
    torch.cuda.empty_cache()
    return {k: sum(got[k] for _, got in records) for k in records[0][1]}


def parallel_phase(torch, ops, dev):
    """Phase 11: the dry run on the fake 16x16 mesh, then CARD_CELLS on a
    one-rank NCCL group (a FileStore: no network) and a (1, 1) cuda mesh.
    Returns each card cell's launches."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    t0 = time.perf_counter()
    dryrun_cells(torch)
    log(f"parallel: dry run of {len(DRYRUN_CELLS)} cells in {time.perf_counter() - t0:.1f} s")
    launches = {}
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
    return launches


def kernels_line(results, path_launches, ops):
    """The ``kernels`` line: one entry per kernel, at its main-path case,
    with its launches summed over the main paths' runs (``path_launches``:
    each path's ``_launch_counts``), by path, by route and by flash shape."""
    total = {}
    for counts in path_launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    flash_routes = {r: total[f"flash/{r}"] for r in ops.FLASH_ROUTES}
    flash_shapes = {k[len("flash/"):]: v for k, v in total.items()
                    if k.startswith("flash/") and " K=" in k and v}
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
                    help="comma list of rmsnorm, flash, ssd, prefill_profile, parallel: run the "
                         "device and build phases and these, then stop (to time another tree's "
                         "kernels beside this one's in one chip call, or phase 11 alone)")
    ap.add_argument("--src", type=Path, default=ROOT,
                    help="root of the checkout whose src/repro_torch is run (default: this one)")
    args = ap.parse_args(argv)
    args.only = [p for p in args.only.split(",") if p]
    unknown = set(args.only) - {"rmsnorm", "flash", "ssd", "prefill_profile", "parallel"}
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
    for name, cases in (("rmsnorm", rmsnorm_cases), ("flash", flash_cases), ("ssd", ssd_cases)):
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
        if "parallel" in args.only:
            parallel_phase(torch, ops, dev)
        log(f"only {args.only} from {args.src}: done in {time.perf_counter() - t_start:.1f} s")
        return 0

    # 4. serve deepseek-7b at full width (main path 1)
    cfg = get_config("deepseek-7b")
    params = init_params(torch, Model, cfg, dev)
    n = cfg.n_layers
    path_launches = {}  # the launches (_launch_counts) of each main path's run
    path_launches[cfg.name] = serve(
        torch, np, cfg, params, ops, lengths=[200, 5, 83, 161, 44, 122],
        per_pass={"rmsnorm": (2 * n + 1,) * 2, "flash_attention": (n, n), "ssd_scan": (0, 0)},
        routes={"flash_attention": {"prefill": "mma_prefill", "decode": "decode"}},
    )

    # 5. checks
    prefill_decode_consistency(torch, np, cfg, params)
    small_model_against_cpu(torch, np, ops)

    # 6. where a decode step's time goes, and the calibrated curve
    profile_decode(torch, cfg, params)
    calibrate_phase(cfg, params, card)
    del params
    torch.cuda.empty_cache()

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

    # 8. serve qwen3-moe-30b-a3b at full width (main path 5), and its checks
    path_launches["qwen3-moe-30b-a3b"] = moe_phase(torch, np, ops, dev, card)
    torch.cuda.empty_cache()

    # 9. training (main paths 3 and 4), and its checks
    path_launches["deepseek-7b/train"] = train_deepseek(torch, ops, dev)
    torch.cuda.empty_cache()
    path_launches["mamba2-370m/train"] = train_mamba(torch, ops)
    torch.cuda.empty_cache()
    small_train_against_cpu(torch, ops)
    resume_on_card(torch)

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

    # 11. the parallel and launch layer: the dry run, and its cells on the card
    path_launches.update(parallel_phase(torch, ops, dev))

    line = kernels_line(results, path_launches, ops)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def init_params(torch, Model, cfg, dev):
    from repro_torch.models.model import n_params

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    log(f"init: {cfg.name} {cfg.n_layers} layers, {n_params(params)} params in {cfg.dtype}, "
        f"{time.perf_counter() - t0:.1f} s; memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return params


if __name__ == "__main__":
    sys.exit(main())
