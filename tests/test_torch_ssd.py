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
