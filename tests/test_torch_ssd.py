"""The port's SSD scan (``ops.ssd_scan`` and its plain versions) against the
JAX package: the Pallas kernel in interpret mode (as
tests/test_kernels_ssd.py runs it), the sequential oracle
``ref.ssd_scan_ref`` and the model's ``ssd_chunked``.

On the CPU ``ops.ssd_scan`` runs ``ref.ssd_chunked_ref``; the CUDA kernel
is held against it on the card by tests/test_torch_kernels_cuda.py and
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.mamba import ssd_chunked  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 2e-4, "bfloat16": 5e-2}  # tests/test_kernels_ssd.py's

SWEEP = [  # (B, S, H, P, N, chunk): tests/test_kernels_ssd.py's SWEEP
    (1, 128, 2, 64, 128, 128),
    (2, 256, 4, 64, 128, 128),
    (1, 256, 2, 32, 64, 64),
    (2, 96, 2, 64, 128, 32),  # S not a chunk multiple
    (1, 200, 3, 16, 32, 64),
]


def _mk(B, S, H, P, N, seed=0):
    """Float32 numpy inputs, drawn as tests/test_kernels_ssd.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, size=(B, S, H)).astype(np.float32)
    A = -rng.uniform(0.5, 4.0, size=(H,)).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _jax(args, dtype):
    x, dt, A, Bm, Cm = args
    cast = _JDT[dtype]
    return (jnp.asarray(x, cast), jnp.asarray(dt), jnp.asarray(A),
            jnp.asarray(Bm, cast), jnp.asarray(Cm, cast))


def _torch(args, dtype):
    x, dt, A, Bm, Cm = args
    cast = _TDT[dtype]
    return (torch.tensor(x).to(cast), torch.tensor(dt), torch.tensor(A),
            torch.tensor(Bm).to(cast), torch.tensor(Cm).to(cast))


def _close(t, j, tol):
    np.testing.assert_allclose(
        t.float().numpy(), np.asarray(j, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("shape", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_matches_pallas_and_sequential(shape, dtype):
    B, S, H, P, N, chunk = shape
    args = _mk(B, S, H, P, N)
    y, state = ops.ssd_scan(*_torch(args, dtype), chunk)
    assert y.dtype == _TDT[dtype] and y.shape == (B, S, H, P)
    assert state.dtype == torch.float32 and state.shape == (B, H, N, P)
    yj, sj = jops.ssd_scan(*_jax(args, dtype), chunk=chunk)
    y_seq, s_seq = jref.ssd_scan_ref(*_jax(args, dtype))
    tol = _TOL[dtype]
    _close(y, yj, tol)
    _close(y, y_seq, tol)
    _close(state, s_seq, tol)


@pytest.mark.parametrize("shape", SWEEP[2:])
def test_plain_versions_match_jax_oracles(shape):
    """ssd_scan_ref against the JAX sequential oracle, ssd_chunked_ref
    against the JAX model's ssd_chunked, both with an initial state."""
    B, S, H, P, N, chunk = shape
    args = _mk(B, S, H, P, N, seed=1)
    h0 = np.random.default_rng(2).normal(size=(B, H, N, P)).astype(np.float32)
    jargs, targs = _jax(args, "float32"), _torch(args, "float32")
    y_seq, s_seq = jref.ssd_scan_ref(*jargs, init_state=jnp.asarray(h0))
    y, s = ref.ssd_scan_ref(*targs, init_state=torch.tensor(h0))
    _close(y, y_seq, 2e-4)
    _close(s, s_seq, 2e-4)
    yc, sc = ssd_chunked(*jargs, chunk, init_state=jnp.asarray(h0))
    y, s = ref.ssd_chunked_ref(*targs, chunk, init_state=torch.tensor(h0))
    assert y.dtype == torch.float32
    _close(y, yc, 2e-4)
    _close(s, sc, 2e-4)


@pytest.mark.parametrize("chunk", [16, 64])
def test_init_state_continues_the_scan(chunk):
    """The first half's final state fed into the second half gives the
    whole sequence's output and state (tests/test_kernels_ssd.py's
    continuation, through the port's wrapper on both halves)."""
    x, dt, A, Bm, Cm = _torch(_mk(1, 200, 2, 32, 64, seed=3), "float32")
    y_full, s_full = ops.ssd_scan(x, dt, A, Bm, Cm, chunk)
    _, s_half = ops.ssd_scan(x[:, :90], dt[:, :90], A, Bm[:, :90], Cm[:, :90], chunk)
    y2, s2 = ops.ssd_scan(
        x[:, 90:], dt[:, 90:], A, Bm[:, 90:], Cm[:, 90:], chunk, init_state=s_half
    )
    _close(y2, y_full[:, 90:].numpy(), 2e-4)
    _close(s2, s_full.numpy(), 2e-4)
    jx = tuple(jnp.asarray(t.numpy()) for t in (x, dt, A, Bm, Cm))
    y_seq, s_seq = jref.ssd_scan_ref(
        *(t[:, 90:] if t.ndim > 1 else t for t in jx), init_state=jnp.asarray(s_half.numpy())
    )
    _close(y2, y_seq, 2e-4)
    _close(s2, s_seq, 2e-4)


def test_out_dtype_and_strided_inputs():
    """bf16 inputs with an fp32 y (the model path), read from slices of one
    xBC tensor, equal the same scan on dense copies."""
    B, S, H, P, N = 2, 40, 2, 16, 16
    rng = np.random.default_rng(4)
    xbc = torch.tensor(rng.normal(size=(B, S, H * P + 2 * N)).astype(np.float32)).bfloat16()
    x = xbc[..., : H * P].view(B, S, H, P)
    Bm, Cm = xbc[..., H * P : H * P + N], xbc[..., H * P + N :]
    assert not x.is_contiguous() and not Bm.is_contiguous()
    dt = torch.tensor(rng.uniform(0.001, 0.1, size=(B, S, H)).astype(np.float32))
    A = -torch.tensor(rng.uniform(0.5, 4.0, size=(H,)).astype(np.float32))
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, 16, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    y2, s2 = ops.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(), 16)
    assert y2.dtype == torch.bfloat16
    torch.testing.assert_close(y.bfloat16(), y2, atol=0, rtol=0)
    torch.testing.assert_close(s, s2, atol=0, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm = _torch(_mk(1, 32, 2, 16, 16), "float32")
    with pytest.raises(ValueError, match="chunk=24"):
        ops.ssd_scan(x, dt, A, Bm, Cm, 24)
    with pytest.raises(ValueError, match="P=8"):
        ops.ssd_scan(x[..., :8], dt, A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="B and C"):
        ops.ssd_scan(x, dt, A, Bm[:, :16], Cm, 16)
    with pytest.raises(ValueError, match="dt must be"):
        ops.ssd_scan(x, dt[:, :, :1], A, Bm, Cm, 16)
    with pytest.raises(ValueError, match="init_state"):
        ops.ssd_scan(x, dt, A, Bm, Cm, 16, init_state=torch.zeros(1, 2, 16, 16).double())
    with pytest.raises(TypeError, match="dtypes differ"):
        ops.ssd_scan(x.bfloat16(), dt, A, Bm, Cm, 16)
    with pytest.raises(TypeError, match="not supported"):
        ops.ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), 16)
    with pytest.raises(TypeError, match="out_dtype"):
        ops.ssd_scan(x, dt, A, Bm, Cm, 16, out_dtype=torch.float64)
    n = ops.LAUNCHES["ssd_scan"]
    ops.ssd_scan(x, dt, A, Bm, Cm, 16)
    assert ops.LAUNCHES["ssd_scan"] == n  # the plain version launches nothing


# --------------------------------------------------------------------------
# the card's routes: which kernel a call would run (decided on the host)
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype,P,N,chunk,aligned,route",
    [(torch.bfloat16, 64, 128, 128, True, "mma"),  # the mamba2-370m prefill
     (torch.bfloat16, 32, 64, 64, True, "mma"),
     (torch.bfloat16, 128, 64, 128, True, "mma"),
     (torch.float32, 64, 128, 128, True, "fma"),  # fp32: the fp32 kernel
     (torch.bfloat16, 64, 128, 128, False, "fma"),  # rows not 16-byte aligned
     (torch.bfloat16, 16, 128, 128, True, "fma"),  # P not a multiple of 32
     (torch.bfloat16, 64, 32, 128, True, "fma"),  # N below 64
     (torch.bfloat16, 64, 128, 16, True, "fma"),  # chunk below 64
     (torch.bfloat16, 16, 16, 16, True, "fma")],  # the reduced config's sizes
)
def test_ssd_route_by_dtype_sizes_and_alignment(dtype, P, N, chunk, aligned, route):
    """bfloat16 with chunk and N in {64, 128}, P a multiple of 32 and
    aligned rows takes the tensor-core kernel; everything else the fp32
    FMA kernel.  Every name has a code in the C entry point."""
    assert ops._ssd_route(dtype, P, N, chunk, aligned) == route
    assert set(ops.SSD_ROUTES) == set(ops._SSD_ROUTE_CODES)


def test_ssd_alignment_of_the_model_views():
    """The Mamba block's xBC views (row stride 2304, offsets 0, 2048 and
    2176 elements) are aligned; a view 4 elements in, or a row stride that
    is no multiple of 8, is not."""
    H, P, N = 32, 64, 128
    xbc = torch.zeros(2, 5, H * P + 2 * N, dtype=torch.bfloat16)
    x = xbc[..., : H * P].view(2, 5, H, P)
    Bm, Cm = xbc[..., H * P : H * P + N], xbc[..., H * P + N :]
    assert ops._ssd_aligned(x, Bm, Cm)
    assert not ops._ssd_aligned(x, xbc[..., 4 : 4 + N], Cm)
    odd = torch.zeros(2, 5, N + 4, dtype=torch.bfloat16)[..., :N]
    assert not ops._ssd_aligned(x, odd, Cm)


def test_ssd_workspace_bytes():
    """Two flags and a decay per (chunk but the last, block of 32 columns),
    a flag per (group of 8 chunks but the last, block) and a ticket, to 16
    bytes; then the fp32 states of every chunk and group but the last."""
    assert ops._ssd_workspace_bytes(1, 512, 32, 64, 128, 128) == 1552 + 4 * 3 * 32 * 128 * 64
    assert ops._ssd_workspace_bytes(1, 128, 32, 64, 128, 128) == 16  # one chunk: no state
    assert ops._ssd_workspace_bytes(2, 129, 4, 32, 64, 64) == 144 + 4 * 2 * 2 * 4 * 64 * 32
    # 9 chunks: two groups, so one group state too
    assert ops._ssd_workspace_bytes(1, 1100, 2, 64, 64, 128) == 288 + 4 * 9 * 2 * 64 * 64


def test_cpu_ssd_counts_no_route_and_reset_clears_routes():
    ops.SSD_ROUTES["mma"] += 2
    ops.reset_launches()
    ops.ssd_scan(*_torch(_mk(1, 40, 2, 32, 64), "bfloat16"), 64)
    assert ops.SSD_ROUTES == {"mma": 0, "fma": 0}
