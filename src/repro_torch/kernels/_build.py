"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The library is named by
a hash of the sources and flags, so an edited source is never served from
a stale build.  It lives under ``build/repro_torch/`` at the root of the
checkout, which ``.gitignore`` lists.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# C signature of every kernel entry point: (argtypes), returning the
# cudaError_t of the launch as an int.
SIGNATURES = {
    # x, scale, y, rows, D, eps, dtype, stream
    "rmsnorm_fwd": (_P, _P, _P, _I64, _I, _F, _I, _P),
    # q, k, v, q_pos, q_pos_bstride, kv_pos, out, B, Sq, T, H, G, K,
    # causal, has_window, window, dtype, route, stream
    "flash_attention_fwd": (_P, _P, _P, _P, _I64, _P, _P) + (_I,) * 11 + (_P,),
    # x, x_bstride, x_sstride, dt, A, Bm, b_bstride, b_sstride, Cm,
    # c_bstride, c_sstride, init_state, y, state, B, S, H, P, N, chunk,
    # dtype, out_dtype, route, ws, stream
    "ssd_scan_fwd": (_P, _I64, _I64, _P, _P, _P, _I64, _I64, _P, _I64, _I64,
                     _P, _P, _P) + (_I,) * 9 + (_P, _P),
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
        "port's CUDA kernels are built from csrc/ on the GPU machine"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        staged = Path(tmp) / out.name
        subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(staged)],
            check=True, capture_output=True, text=True,
        )
        os.replace(staged, out)  # atomic: a concurrent loader sees all or nothing


def load() -> ctypes.CDLL:
    """The kernels' library, compiled first if no build of these sources
    exists yet."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
