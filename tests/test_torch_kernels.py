"""The port's kernel modules against the JAX package.

On the CPU the port's wrappers run their plain versions; those are held
against the Pallas kernels in interpret mode (as tests/test_kernels_*.py
run them) and, where the Pallas kernel cannot take the shapes (Sq = 1,
per-row positions), against the JAX model's attention.  The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a, dtype="float32"):
    return jnp.asarray(a, _JDT[dtype]), torch.tensor(a).to(_TDT[dtype])


def _close(out_t, out_j, tol):
    np.testing.assert_allclose(
        out_t.float().numpy(), np.asarray(out_j, np.float32), atol=tol, rtol=tol
    )


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 64), (2, 300, 512), (1, 7, 128), (3, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    x_j, x_t = _both(rng.normal(size=shape).astype(np.float32), dtype)
    s = rng.normal(size=shape[-1:]).astype(np.float32)
    out = ops.rmsnorm(x_t, torch.tensor(s))
    assert out.dtype == x_t.dtype and out.shape == x_t.shape
    _close(out, jops.rmsnorm(x_j, jnp.asarray(s)), 1e-5 if dtype == "float32" else 2e-2)


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------


def _mk(B, Sq, T, H, G, K, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, K)).astype(np.float32)
    k = rng.normal(size=(B, T, G, K)).astype(np.float32)
    v = rng.normal(size=(B, T, G, K)).astype(np.float32)
    return q, k, v, np.arange(T - Sq, T, dtype=np.int32), np.arange(T, dtype=np.int32)


def _flash_pair(q, k, v, qpos, kpos, causal, window, dtype="float32"):
    out_t = ops.flash_attention(
        *(_both(a, dtype)[1] for a in (q, k, v)),
        torch.tensor(qpos), torch.tensor(kpos), causal, window,
    )
    out_j = jops.flash_attention(
        *(_both(a, dtype)[0] for a in (q, k, v)),
        jnp.asarray(qpos), jnp.asarray(kpos), causal, window,
    )
    return out_t, out_j


@pytest.mark.parametrize(
    "shape",
    [
        # (B, Sq, T, H, G, K): a subset of test_kernels_flash.SHAPE_SWEEP
        (1, 128, 128, 4, 4, 128),  # MHA
        (1, 128, 128, 4, 1, 128),  # MQA
        (1, 128, 384, 4, 2, 128),  # cache longer than queries
        (2, 128, 128, 4, 2, 64),  # small head dim
    ],
)
def test_flash_matches_pallas(shape):
    out_t, out_j = _flash_pair(*_mk(*shape), True, None)
    _close(out_t, out_j, 2e-5)


@pytest.mark.parametrize(
    "case",
    ["window", "non_causal", "empty_slots"],
)
def test_flash_masks_match_pallas(case):
    q, k, v, qpos, kpos = _mk(1, 128, 256, 4, 2, 128)
    causal, window = True, None
    if case == "window":
        q, k, v, qpos, kpos = _mk(1, 256, 256, 4, 2, 128)
        window = 96
    elif case == "non_causal":
        q, k, v, qpos, kpos = _mk(2, 128, 128, 4, 4, 64)
        causal = False
    else:  # ring-buffer slots with pos = -1 are ignored
        kpos[200:] = -1
    out_t, out_j = _flash_pair(q, k, v, qpos, kpos, causal, window)
    _close(out_t, out_j, 2e-5)


def test_flash_fully_masked_row_is_mean_of_v():
    """-1e30 semantics: a row that sees no key averages v over all T keys
    (the JAX reference's answer), and is never NaN."""
    q, k, v, _, kpos = _mk(1, 4, 8, 2, 1, 64)
    qpos = np.array([-3, -2, 5, 7], np.int32)  # rows 0-1 precede every key
    kpos[6:] = -1
    args_t = [torch.tensor(a) for a in (q, k, v, qpos, kpos)]
    out = ops.flash_attention(*args_t, True, None)
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v, qpos, kpos)), True, None)
    _close(out, want, 2e-5)
    np.testing.assert_allclose(
        out[0, :2].numpy(), np.broadcast_to(v[0].mean(0), (2, 2, 64)), atol=1e-6
    )


@pytest.mark.parametrize("G", [4, 2])
def test_flash_per_row_decode_matches_jax_attention(G):
    """Sq = 1 with per-row q_pos [B,1] over a cache with -1 tail slots (the
    serving decode), which the Pallas kernel cannot take."""
    B, T, H, K = 3, 40, 4, 16
    q, k, v, _, _ = _mk(B, 1, T, H, G, K, seed=1)
    kpos = np.where(np.arange(T) < 30, np.arange(T), -1).astype(np.int32)
    qpos = np.array([[4], [17], [29]], np.int32)
    out = ops.flash_attention(*(torch.tensor(a) for a in (q, k, v, qpos, kpos)), True, None)
    want = JL.multi_head_attention(
        *(jnp.asarray(a) for a in (q, k, v, qpos, kpos)), True, None
    )
    _close(out, want, 2e-5)


def test_wrappers_dispatch_on_tensor_device():
    """CPU tensors take the plain versions and launch nothing."""
    ops.reset_launches()
    x = torch.ones(2, 8)
    ops.rmsnorm(x, torch.ones(8))
    q, k, v, qpos, kpos = (torch.tensor(a) for a in _mk(1, 2, 4, 2, 2, 64))
    ops.flash_attention(q, k, v, qpos, kpos)
    x4 = torch.ones(1, 3, 2, 16)
    ops.ssd_scan(x4, torch.ones(1, 3, 2), -torch.ones(2), torch.ones(1, 3, 16), torch.ones(1, 3, 16), 16)
    assert ops.LAUNCHES == {"rmsnorm": 0, "flash_attention": 0, "ssd_scan": 0}
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.rmsnorm(x, torch.ones(8, device="meta"))


@pytest.mark.parametrize(
    "Sq,dtype,route",
    [(1, torch.float32, "decode"), (1, torch.bfloat16, "decode"),
     (2, torch.bfloat16, "mma_prefill"), (200, torch.bfloat16, "mma_prefill"),
     (2, torch.float32, "fma"), (200, torch.float32, "fma")],
)
def test_flash_route_by_query_length_and_dtype(Sq, dtype, route):
    """One query position takes the decode kernel in either type; several
    take the tensor-core kernel in bfloat16 and the fp32 FMA kernel in
    float32.  Every name has a code in the C entry point."""
    assert ops._flash_route(Sq, dtype) == route
    assert set(ops.FLASH_ROUTES) == set(ops._FLASH_ROUTE_CODES)


def test_cpu_flash_counts_no_route_and_reset_clears_routes():
    ops.FLASH_SHAPES["decode K=128 causal"] = 3
    assert ops.FLASH_ROUTES["decode"] == 3
    ops.reset_launches()
    q, k, v, qpos, kpos = (torch.tensor(a) for a in _mk(1, 1, 4, 2, 2, 64))
    ops.flash_attention(q, k, v, qpos, kpos)
    assert ops.FLASH_ROUTES == {"decode": 0, "mma_prefill": 0, "fma": 0}


def test_flash_shape_keys_and_reset_clears_them():
    """FLASH_SHAPES names a launch by route, head dim and mask; a CPU call
    adds none, and reset_launches empties it."""
    assert ops._flash_shape("mma_prefill", 80, False, None) == "mma_prefill K=80 non-causal"
    assert ops._flash_shape("decode", 120, True, 4096) == "decode K=120 causal window"
    assert ops._flash_shape("fma", 64, True, None) == "fma K=64 causal"
    ops.FLASH_SHAPES["decode K=64 causal"] = 2
    ops.reset_launches()
    q, k, v, qpos, kpos = (torch.tensor(a) for a in _mk(1, 3, 4, 2, 2, 80))
    ops.flash_attention(q, k, v, qpos, kpos, False, 2)
    assert ops.FLASH_SHAPES == {}


# --------------------------------------------------------------------------
# the build
# --------------------------------------------------------------------------


def test_library_is_named_by_a_hash_of_the_sources(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    for src in _build.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    assert before.parent == _build.BUILD_DIR
    with open(tmp_path / "rmsnorm.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path() != before  # an edited source is never served stale


def test_build_without_nvcc_raises(monkeypatch):
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "library_path", lambda: _build.BUILD_DIR / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
