#!/usr/bin/env python3
"""Where the SSD scan's tensor-core kernel spends its time, block by block.

    python3 scripts/ssd_timeline.py [base|noydiag|nostate]

Builds an instrumented copy of src/repro_torch/csrc/ssd_scan.cu (under
build/ssd_timeline/) in which thread 0 of every block of the mma route
records %globaltimer at the boundaries of its phases, with a block-wide
barrier before each mark (so a phase's time is that of its slowest warp,
and work the compiler would move past the next barrier is charged where
it lands), and runs the mamba2-370m prefill shapes (B=1, H=32, P=64,
N=128, chunk 128, bf16 in, fp32 y) once each after an L2 flush.  Prints
each phase's time per block and, per chunk, the medians of when its
blocks reached each mark.  ``noydiag`` and ``nostate`` skip the intra-chunk
output or the chunk-state product (wrong results, for timing only).  One
GPU; no effect on the checkout's own build.
"""
import ctypes
import shutil
import statistics as st
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ["ticket", "stage", "xw+y_diag", "state", "pub+wait", "horner", "y_off"]
SKIPS = {
    "base": [],
    "noydiag": [("  if (row_warp) {\n#pragma unroll\n    for (int kk = 0; kk < N / 16; ++kk)\n",
                 "  if (false) {\n#pragma unroll\n    for (int kk = 0; kk < N / 16; ++kk)\n")],
    "nostate": [("  if (state_warp) {\n    for (int kb = 0; kb < nt; ++kb) {",
                 "  if (false) {\n    for (int kb = 0; kb < nt; ++kb) {")],
}


def once(s: str, old: str, new: str) -> str:
    assert s.count(old) == 1, f"instrumentation point not found once: {old!r}"
    return s.replace(old, new)


def instrument(src: str, variant: str) -> str:
    s = once(src, "namespace {\n", """namespace {
__device__ unsigned long long g_tl[8192][9];  // per ticket: 8 marks, the SM
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
""")
    s = once(s, "  if (tid == 0) work_s = int(atomicAdd(",
             "  const unsigned long long t_entry = gtime();\n  if (tid == 0) work_s = int(atomicAdd(")
    s = once(s, "  // Tickets run chunk by chunk",
             "  if (tid == 0) {\n    unsigned sm;\n    asm(\"mov.u32 %0, %smid;\" : \"=r\"(sm));\n"
             "    g_tl[work_s][0] = t_entry; g_tl[work_s][1] = gtime(); g_tl[work_s][8] = sm;\n  }\n"
             "  // Tickets run chunk by chunk")
    mark = lambda k: f"  if (tid == 0) g_tl[work_s][{k}] = gtime();\n"
    s = once(s, "  cp_async_wait_all();\n  __syncthreads();\n",
             "  cp_async_wait_all();\n  __syncthreads();\n" + mark(2))
    for k, pat in ((3, "  // ---- 4. the chunk's own state"), (4, "  // ---- 5. h_{c-1}")):
        s = once(s, pat, "  __syncthreads();\n" + mark(k) + pat)
    s = once(s, "  __syncthreads();\n  // h_{c-1} by Horner",
             "  __syncthreads();\n" + mark(5) + "  // h_{c-1} by Horner")
    s = once(s, "  if (tid == 0 && publish_inc) st_release(", mark(6) + "  if (tid == 0 && publish_inc) st_release(")
    end = "               yr + nb * 8);\n    }\n  }\n}\n"
    s = once(s, end, end[:-2] + "  __syncthreads();\n" + mark(7) + "}\n")
    for old, new in SKIPS[variant]:
        s = once(s, old, new)
    return s + ('\nextern "C" int ssd_tl_read(void* dst, int n) {\n'
                '  return int(cudaMemcpyFromSymbol(dst, g_tl, size_t(n) * 9 * 8));\n}\n')


def main() -> int:
    variant = sys.argv[1] if len(sys.argv) > 1 else "base"
    work = ROOT / "build" / "ssd_timeline" / variant
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(ROOT / "src", work / "src")
    cu = work / "src/repro_torch/csrc/ssd_scan.cu"
    cu.write_text(instrument(cu.read_text(), variant))
    sys.path.insert(0, str(work / "src"))
    import torch

    if not torch.cuda.is_available():
        print("ssd_timeline: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ops

    lib = _build.load()
    lib.ssd_tl_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dev = torch.device("cuda")
    flush = torch.empty(64 << 18, device=dev)  # 64 MB, more than the L2
    H, P, N, Q = 32, 64, 128, 128
    for B, S in ((1, 512), (1, 300), (1, 200)):
        g = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(B, S, H, P, generator=g, device=dev).bfloat16()
        dt = torch.rand(B, S, H, generator=g, device=dev) * 0.099 + 0.001
        A = -(torch.rand(H, generator=g, device=dev) * 3.5 + 0.5)
        Bm = torch.randn(B, S, N, generator=g, device=dev).bfloat16()
        Cm = torch.randn(B, S, N, generator=g, device=dev).bfloat16()
        for _ in range(3):
            ops.ssd_scan(x, dt, A, Bm, Cm, Q, out_dtype=torch.float32)
        flush.zero_()
        ops.ssd_scan(x, dt, A, Bm, Cm, Q, out_dtype=torch.float32)
        torch.cuda.synchronize()
        nc = -(-S // Q)
        nblk = B * H * nc * (P // _cols(B * H * nc, torch, dev))  # blocks of the launch
        buf = (ctypes.c_ulonglong * (nblk * 9))()
        assert lib.ssd_tl_read(ctypes.addressof(buf), nblk) == 0
        rows = [list(buf[i * 9:(i + 1) * 9]) for i in range(nblk)]
        t0 = min(r[0] for r in rows)
        print(f"[{variant}] B={B} S={S}: {nblk} blocks on {len({r[8] for r in rows})} SMs, "
              f"first entry to last exit {(max(r[7] for r in rows) - t0) / 1e3:.2f} us")
        for k, name in enumerate(PHASES):
            d = [(r[k + 1] - r[k]) / 1e3 for r in rows]
            print(f"   {name:9s} us per block: min {min(d):6.2f} median {st.median(d):6.2f} "
                  f"max {max(d):6.2f}")
        per_c = nblk // nc
        for c in range(nc):
            rs = rows[c * per_c:(c + 1) * per_c]
            at = [st.median((r[k] - t0) / 1e3 for r in rs) for k in (0, 2, 4, 5, 6, 7)]
            print(f"   chunk {c} medians, us from the first entry: entry {at[0]:.2f}, staged "
                  f"{at[1]:.2f}, state done {at[2]:.2f}, waits over {at[3]:.2f}, h ready "
                  f"{at[4]:.2f}, exit {at[5]:.2f}")
    return 0


def _cols(blocks_at_64: int, torch, dev) -> int:
    """mma_cols of csrc/ssd_scan.cu for P = 64."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return 64 if 4 * blocks_at_64 >= 3 * sms else 32


if __name__ == "__main__":
    sys.exit(main())
