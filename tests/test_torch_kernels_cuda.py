"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``cuda`` and skips without a CUDA device;
the file imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built with nvcc and run on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 37, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(cuda_device, rows, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(rows, 4096, generator=gen, device=cuda_device).to(_TDT[dtype])
    s = torch.randn(4096, generator=gen, device=cuda_device)
    n = ops.LAUNCHES["rmsnorm"]
    out = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == n + 1
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.rmsnorm_ref(x, s).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,Sq,T,H,G,K,window",
    [(1, 37, 37, 32, 32, 128, None), (2, 256, 256, 32, 8, 128, None),
     (2, 100, 300, 8, 8, 64, None), (1, 256, 256, 8, 2, 128, 96)],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(cuda_device, B, Sq, T, H, G, K, window, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (
        torch.randn(shape, generator=gen, device=cuda_device).to(_TDT[dtype])
        for shape in ((B, Sq, H, K), (B, T, G, K), (B, T, G, K))
    )
    qpos = torch.arange(T - Sq, T, dtype=torch.int32, device=cuda_device)
    kpos = torch.arange(T, dtype=torch.int32, device=cuda_device)
    out = ops.flash_attention(q, k, v, qpos, kpos, True, window)
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, True, window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_kernel_per_row_decode_matches_plain(cuda_device):
    """Sq = 1, per-row q_pos [B,1] spread over a cache with -1 tail slots,
    and one row that sees no key (it must average v, not return NaN)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    B, T, H, G, K = 6, 512, 32, 8, 128
    q = torch.randn(B, 1, H, K, generator=gen, device=cuda_device).bfloat16()
    k, v = (torch.randn(B, T, G, K, generator=gen, device=cuda_device).bfloat16() for _ in "kv")
    ar = torch.arange(T, dtype=torch.int32, device=cuda_device)
    kpos = torch.where(ar < 400, ar, -1)
    qpos = torch.tensor([[-1], [0], [31], [32], [250], [399]], dtype=torch.int32, device=cuda_device)
    out = ops.flash_attention(q, k, v, qpos, kpos, True, None)
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, True, None)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)
