"""The port's CUDA kernels (RMSNorm, flash attention, SSD scan) against
their plain PyTorch versions, on the card.  Every test here is marked
``cuda`` and skips without a CUDA device; the file imports no JAX, so it
runs where only PyTorch is installed:

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
@pytest.mark.parametrize("rows", [1, 4, 37, 300, 4096])
@pytest.mark.parametrize("D", [128, 1000, 1024, 2048, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(cuda_device, rows, D, dtype):
    """The widths the port runs (128, 1024, 2048, 4096) take the row
    kernel; D = 1000 the general kernel."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(rows, D, generator=gen, device=cuda_device).to(_TDT[dtype])
    s = torch.randn(D, generator=gen, device=cuda_device)
    n = ops.LAUNCHES["rmsnorm"]
    out = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == n + 1
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), ref.rmsnorm_ref(x, s).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_unaligned_views(cuda_device, D, dtype):
    """x and scale that start one element past a 16-byte boundary take the
    general kernel at a width the row kernel is built for."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    rows = 37
    x = torch.randn(rows * D + 1, generator=gen, device=cuda_device).to(_TDT[dtype])[1:]
    x = x.view(rows, D)
    s = torch.randn(D + 1, generator=gen, device=cuda_device)[1:]
    assert x.data_ptr() % 16 and s.data_ptr() % 16
    out = ops.rmsnorm(x, s)
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


def _kv(B, T, G, K, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(B, T, G, K, generator=gen, device=device).to(_TDT[dtype]) for _ in "kv")


@pytest.mark.cuda
@pytest.mark.parametrize("K", [64, 80, 120, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hg", [1, 4, 8])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 100, 512, 1000])
def test_flash_decode_route_matches_plain(cuda_device, T, Hg, dtype, K):
    """The decode route (Sq = 1): per-row q_pos over a cache with -1 tail
    slots, with a row that sees no key (q_pos = -1), a row whose visible
    keys all lie in the first warp's run (q_pos = 0), and rows at the middle
    and the end; then the same queries over a cache with every slot -1."""
    G = 2
    H = G * Hg
    gen = torch.Generator(device=cuda_device).manual_seed(T * 100 + Hg)
    q = torch.randn(4, 1, H, K, generator=gen, device=cuda_device).to(_TDT[dtype])
    k, v = _kv(4, T, G, K, dtype, cuda_device, seed=T + Hg)
    ar = torch.arange(T, dtype=torch.int32, device=cuda_device)
    filled = max(1, T - T // 8)
    kpos = torch.where(ar < filled, ar, -1)
    qpos = torch.tensor([[-1], [0], [filled // 2], [filled - 1]], dtype=torch.int32,
                        device=cuda_device)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for kv_pos in (kpos, torch.full_like(kpos, -1)):
        n = ops.FLASH_ROUTES["decode"]
        out = ops.flash_attention(q, k, v, qpos, kv_pos, True, None)
        torch.cuda.synchronize()
        assert ops.FLASH_ROUTES["decode"] == n + 1
        assert bool(torch.isfinite(out).all())
        want = ref.flash_attention_ref(q, k, v, qpos, kv_pos, True, None)
        torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    # no key visible anywhere: every row is the mean of v over all T keys
    mean_v = v.float().mean(1).repeat_interleave(Hg, dim=1)[:, None]
    torch.testing.assert_close(out.float(), mean_v, atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [80, 120, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [8, 32])
def test_flash_decode_route_window_ring_buffer(cuda_device, G, dtype, K):
    """The decode route with a sliding window over a ring buffer, where
    slot t holds position t + W * wraps: kv_pos is not monotone in t."""
    B, W, H, window = 3, 256, 32, 96
    q = torch.randn(B, 1, H, K, generator=torch.Generator(device=cuda_device).manual_seed(3),
                    device=cuda_device).to(_TDT[dtype])
    k, v = _kv(B, W, G, K, dtype, cuda_device, seed=4)
    qpos = torch.tensor([[300], [511], [40]], dtype=torch.int32, device=cuda_device)
    slots = torch.arange(W, dtype=torch.int32, device=cuda_device)
    kpos = torch.where(slots <= 300 % W, slots + W, slots)  # positions 256..300, then 45..255
    for kv_pos in (kpos, slots):
        out = ops.flash_attention(q, k, v, qpos, kv_pos, True, window)
        want = ref.flash_attention_ref(q, k, v, qpos, kv_pos, True, window)
        tol = 2e-5 if dtype == "float32" else 2e-2
        torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [64, 80, 120, 128])
@pytest.mark.parametrize("case", ["causal", "chunked", "window", "gqa", "empty_slots", "wide"])
@pytest.mark.parametrize("Sq", [2, 17, 63, 65, 200])
def test_flash_mma_prefill_route_matches_plain(cuda_device, Sq, case, K):
    """The bf16 tensor-core prefill route at lengths that are no multiple
    of its 64-row and 64-key tiles: plain causal; chunked (T > Sq: the
    queries are the last Sq of T positions); a window; GQA; a cache with
    -1 slots in the middle and at the end.  These grids are small enough
    for the kernel to split each key tile between two warps; "wide" (160
    or more blocks, chunked) takes its four-warp form."""
    B, H, G, T, window = 2, 8, 8, Sq, None
    if case == "wide":
        B, H, G, T = 5, 32, 32, Sq + 33
    elif case == "chunked":
        T = Sq + 77
    elif case == "window":
        window = 24
    elif case == "gqa":
        G = 2
    elif case == "empty_slots":
        T = Sq + 40
    gen = torch.Generator(device=cuda_device).manual_seed(Sq)
    q = torch.randn(B, Sq, H, K, generator=gen, device=cuda_device).bfloat16()
    k, v = _kv(B, T, G, K, "bfloat16", cuda_device, seed=Sq + 1)
    qpos = torch.arange(T - Sq, T, dtype=torch.int32, device=cuda_device)
    kpos = torch.arange(T, dtype=torch.int32, device=cuda_device)
    if case == "empty_slots":
        kpos[T // 3 : T // 3 + 5] = -1
        kpos[-7:] = -1
    n = ops.FLASH_ROUTES["mma_prefill"]
    out = ops.flash_attention(q, k, v, qpos, kpos, True, window)
    torch.cuda.synchronize()
    assert ops.FLASH_ROUTES["mma_prefill"] == n + 1
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, True, window)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_flash_mma_prefill_rows_without_keys(cuda_device):
    """Prefill rows that precede every key (q_pos < 0 or below the first
    written position) average v over all T keys, never NaN; per-row q_pos."""
    B, Sq, T, H, G, K = 2, 70, 100, 4, 2, 128
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    q = torch.randn(B, Sq, H, K, generator=gen, device=cuda_device).bfloat16()
    k, v = _kv(B, T, G, K, "bfloat16", cuda_device, seed=10)
    kpos = torch.arange(T, dtype=torch.int32, device=cuda_device) + 20
    qpos = torch.stack([torch.arange(Sq, dtype=torch.int32, device=cuda_device) - 5,
                        torch.arange(Sq, dtype=torch.int32, device=cuda_device) + 30])
    out = ops.flash_attention(q, k, v, qpos, kpos, True, None)
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, True, None)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_flash_routes_by_shape_and_dtype(cuda_device):
    """Each call runs the kernel ``_flash_route`` names, once."""
    for Sq, dtype, route in ((1, "float32", "decode"), (1, "bfloat16", "decode"),
                             (9, "bfloat16", "mma_prefill"), (9, "float32", "fma")):
        q = torch.randn(1, Sq, 4, 64, device=cuda_device).to(_TDT[dtype])
        k, v = _kv(1, 16, 4, 64, dtype, cuda_device, seed=0)
        pos = torch.arange(16 - Sq, 16, dtype=torch.int32, device=cuda_device)
        before = dict(ops.FLASH_ROUTES)
        ops.flash_attention(q, k, v, pos, torch.arange(16, dtype=torch.int32, device=cuda_device))
        after = dict(ops.FLASH_ROUTES)
        assert {r: after[r] - before[r] for r in after} == {
            r: int(r == route) for r in after}, (Sq, dtype)


# qwen3-moe-30b-a3b's serve path: qk-norm over rows of 128, and attention
# with 8 query heads a KV head (H = 32, G = 4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,A", [(4, 1, 32), (4, 1, 4), (1, 300, 32), (1, 300, 4)])
def test_rmsnorm_qk_norm_shapes(cuda_device, B, S, A):
    """q- and k-norm as the attention layer calls them: a [B,S,A,128] bf16
    projection over its last axis (q: 128 rows at a decode step of 4, 9,600
    in a 300-token prefill; k: 16 and 1,200), on the row kernel."""
    gen = torch.Generator(device=cuda_device).manual_seed(B * S + A)
    x = torch.randn(B, S, A, 128, generator=gen, device=cuda_device).bfloat16()
    s = torch.randn(128, generator=gen, device=cuda_device)
    n = ops.LAUNCHES["rmsnorm"]
    out = ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["rmsnorm"] == n + 1 and out.shape == x.shape
    torch.testing.assert_close(out.float(), ref.rmsnorm_ref(x, s).float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_route_eight_heads_a_group(cuda_device, dtype):
    """The decode route at the serve batch (B = 4, a 512-slot cache) with
    per-row positions and Hg = 8, the most query heads its block holds."""
    B, T, H, G, K = 4, 512, 32, 4, 128
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q = torch.randn(B, 1, H, K, generator=gen, device=cuda_device).to(_TDT[dtype])
    k, v = _kv(B, T, G, K, dtype, cuda_device, seed=12)
    ar = torch.arange(T, dtype=torch.int32, device=cuda_device)
    kpos = torch.where(ar < 216, ar, -1)
    qpos = torch.tensor([[215], [20], [98], [176]], dtype=torch.int32, device=cuda_device)
    n = ops.FLASH_ROUTES["decode"]
    out = ops.flash_attention(q, k, v, qpos, kpos, True, None)
    torch.cuda.synchronize()
    assert ops.FLASH_ROUTES["decode"] == n + 1
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, True, None)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [5, 44, 83, 200, 300])
def test_flash_mma_prefill_eight_heads_a_group(cuda_device, Sq):
    """The bf16 prefill route at the serve run's prompt lengths with
    H = 32, G = 4; also against SDPA with enable_gqa."""
    import torch.nn.functional as F

    B, H, G, K = 1, 32, 4, 128
    gen = torch.Generator(device=cuda_device).manual_seed(Sq + 7)
    q = torch.randn(B, Sq, H, K, generator=gen, device=cuda_device).bfloat16()
    k, v = _kv(B, Sq, G, K, "bfloat16", cuda_device, seed=Sq + 8)
    pos = torch.arange(Sq, dtype=torch.int32, device=cuda_device)
    n = ops.FLASH_ROUTES["mma_prefill"]
    out = ops.flash_attention(q, k, v, pos, pos, True, None)
    torch.cuda.synchronize()
    assert ops.FLASH_ROUTES["mma_prefill"] == n + 1
    want = ref.flash_attention_ref(q, k, v, pos, pos, True, None)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)
    lib = F.scaled_dot_product_attention(
        *(t.transpose(1, 2) for t in (q, k, v)), is_causal=True, enable_gqa=True
    ).transpose(1, 2)
    torch.testing.assert_close(out.float(), lib.float(), atol=2e-2, rtol=2e-2)


def _ssd_inputs(B, S, H, P, N, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=gen, device=device).to(_TDT[dtype])
    dt = torch.rand(B, S, H, generator=gen, device=device) * 0.099 + 0.001
    A = -(torch.rand(H, generator=gen, device=device) * 3.5 + 0.5)
    Bm = torch.randn(B, S, N, generator=gen, device=device).to(_TDT[dtype])
    Cm = torch.randn(B, S, N, generator=gen, device=device).to(_TDT[dtype])
    return x, dt, A, Bm, Cm


@pytest.mark.cuda
@pytest.mark.parametrize(
    "B,S,H,P,N,chunk",
    [(1, 512, 32, 64, 128, 128),  # the mamba2-370m prefill shape
     (1, 200, 32, 64, 128, 128),  # tail chunk
     (2, 256, 4, 64, 128, 128), (1, 256, 2, 32, 64, 64), (2, 96, 2, 64, 128, 32),
     (1, 200, 3, 16, 32, 64), (1, 37, 8, 16, 16, 16), (1, 1, 4, 128, 128, 16)],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_matches_plain(cuda_device, B, S, H, P, N, chunk, dtype):
    args = _ssd_inputs(B, S, H, P, N, dtype, cuda_device)
    n = ops.LAUNCHES["ssd_scan"]
    y, state = ops.ssd_scan(*args, chunk)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ssd_scan"] == n + 1
    assert y.dtype == args[0].dtype and state.dtype == torch.float32
    y_want, s_want = ref.ssd_chunked_ref(*args, chunk)
    tol = 2e-4 if dtype == "float32" else 5e-2
    torch.testing.assert_close(y.float(), y_want, atol=tol, rtol=tol)
    torch.testing.assert_close(state, s_want, atol=tol, rtol=tol)
    torch.testing.assert_close(state, ref.ssd_scan_ref(*args)[1], atol=tol, rtol=tol)


@pytest.mark.cuda
def test_ssd_kernel_init_state_and_strided_inputs(cuda_device):
    """Slices of one xBC tensor (the model path), an fp32 y, and the first
    half's state fed into the second half."""
    B, S, H, P, N = 1, 300, 32, 64, 128
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    xbc = torch.randn(B, S, H * P + 2 * N, generator=gen, device=cuda_device).bfloat16()
    x = xbc[..., : H * P].view(B, S, H, P)
    Bm, Cm = xbc[..., H * P : H * P + N], xbc[..., H * P + N :]
    dt = torch.rand(B, S, H, generator=gen, device=cuda_device) * 0.099 + 0.001
    A = -(torch.rand(H, generator=gen, device=cuda_device) * 3.5 + 0.5)
    y, s = ops.ssd_scan(x, dt, A, Bm, Cm, 128, out_dtype=torch.float32)
    y_want, s_want = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, 128)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, y_want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s, s_want, atol=2e-4, rtol=2e-4)
    _, s1 = ops.ssd_scan(x[:, :150], dt[:, :150], A, Bm[:, :150], Cm[:, :150], 128)
    y2, s2 = ops.ssd_scan(x[:, 150:], dt[:, 150:], A, Bm[:, 150:], Cm[:, 150:], 128,
                          init_state=s1, out_dtype=torch.float32)
    torch.testing.assert_close(y2, y_want[:, 150:], atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s2, s_want, atol=2e-4, rtol=2e-4)


def _ssd_mma(args, chunk, **kw):
    """One call that must take the tensor-core route."""
    n = ops.SSD_ROUTES["mma"]
    y, state = ops.ssd_scan(*args, chunk, **kw)
    torch.cuda.synchronize()
    assert ops.SSD_ROUTES["mma"] == n + 1
    return y, state


@pytest.mark.cuda
@pytest.mark.parametrize("ydtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("S", [1, 2, 5, 127, 128, 129, 300, 512])
def test_ssd_mma_route_matches_plain(cuda_device, S, B, ydtype):
    """bf16 x, B, C at the mamba2-370m widths (P 64, N 128, chunk 128) over
    lengths that are no chunk multiple, one chunk and several; y in fp32
    (the model's call) or bf16; the same bits from a second call."""
    args = _ssd_inputs(B, S, 8, 64, 128, "bfloat16", cuda_device, seed=S + B)
    ydt = _TDT[ydtype]
    y, state = _ssd_mma(args, 128, out_dtype=ydt)
    assert y.dtype == ydt and bool(torch.isfinite(y).all())
    y_want, s_want = ref.ssd_chunked_ref(*args, 128)
    tol = 2e-4 if ydtype == "float32" else 5e-2
    torch.testing.assert_close(y.float(), y_want, atol=tol, rtol=tol)
    torch.testing.assert_close(state, s_want, atol=2e-4, rtol=2e-4)
    y2, state2 = _ssd_mma(args, 128, out_dtype=ydt)
    assert torch.equal(y, y2) and torch.equal(state, state2)


@pytest.mark.cuda
@pytest.mark.parametrize("P", [32, 64, 128])
@pytest.mark.parametrize("N", [64, 128])
@pytest.mark.parametrize("chunk", [64, 128])
def test_ssd_mma_route_sizes(cuda_device, P, N, chunk):
    """Every P, N and chunk the tensor-core route takes, over a tail chunk
    and a batch of 2, fp32 y."""
    args = _ssd_inputs(2, 200, 3, P, N, "bfloat16", cuda_device, seed=P + N + chunk)
    y, state = _ssd_mma(args, chunk, out_dtype=torch.float32)
    y_want, s_want = ref.ssd_chunked_ref(*args, chunk)
    torch.testing.assert_close(y, y_want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(state, s_want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(state, ref.ssd_scan_ref(*args)[1], atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [1, 150, 256])
def test_ssd_mma_route_init_state_and_model_views(cuda_device, split):
    """Slices of one xBC tensor, as the Mamba block passes them (row stride
    2304, offsets 0, 2048, 2176), an fp32 y, and the state after `split`
    tokens carried into the rest."""
    B, S, H, P, N = 1, 300, 32, 64, 128
    gen = torch.Generator(device=cuda_device).manual_seed(split)
    xbc = torch.randn(B, S, H * P + 2 * N, generator=gen, device=cuda_device).bfloat16()
    x = xbc[..., : H * P].view(B, S, H, P)
    Bm, Cm = xbc[..., H * P : H * P + N], xbc[..., H * P + N :]
    dt = torch.rand(B, S, H, generator=gen, device=cuda_device) * 0.099 + 0.001
    A = -(torch.rand(H, generator=gen, device=cuda_device) * 3.5 + 0.5)
    y_want, s_want = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, 128)
    head = (x[:, :split], dt[:, :split], A, Bm[:, :split], Cm[:, :split])
    _, s1 = _ssd_mma(head, 128)
    tail = (x[:, split:], dt[:, split:], A, Bm[:, split:], Cm[:, split:])
    y2, s2 = _ssd_mma(tail, 128, init_state=s1, out_dtype=torch.float32)
    torch.testing.assert_close(y2, y_want[:, split:], atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s2, s_want, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_ssd_mma_route_large_decay(cuda_device):
    """|A| dt up to 4 a step: over a chunk the masked cum_i - cum_j (j > i)
    passes 88, where expf overflows, so the kernel must select before exp;
    no NaN or inf.  (Far larger decays make cum itself lose digits in fp32:
    at |A| dt ~ 200 a step the plain chunked and sequential versions
    already differ by 2e-3.)"""
    x, dt, A, Bm, Cm = _ssd_inputs(1, 300, 8, 64, 128, "bfloat16", cuda_device, seed=11)
    A = A * 10
    assert float((dt[:, :128] * -A).sum(1).max()) > 88  # a masked exp would overflow
    y, state = _ssd_mma((x, dt, A, Bm, Cm), 128, out_dtype=torch.float32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(state).all())
    y_want, s_want = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, 128)
    torch.testing.assert_close(y, y_want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(state, s_want, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("S,chunk", [(1024, 128), (1025, 128), (1100, 64), (2100, 64)])
def test_ssd_mma_route_across_groups(cuda_device, S, chunk):
    """More than one group of 8 chunks: the state after each group is
    carried to the next; with an initial state and the same bits twice."""
    args = _ssd_inputs(1, S, 4, 64, 128, "bfloat16", cuda_device, seed=S)
    init = torch.randn(1, 4, 128, 64, generator=torch.Generator(device=cuda_device).manual_seed(1),
                       device=cuda_device)
    y, state = _ssd_mma(args, chunk, init_state=init, out_dtype=torch.float32)
    y_want, s_want = ref.ssd_chunked_ref(*args, chunk, init_state=init)
    torch.testing.assert_close(y, y_want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(state, s_want, atol=2e-4, rtol=2e-4)
    y2, state2 = _ssd_mma(args, chunk, init_state=init, out_dtype=torch.float32)
    assert torch.equal(y, y2) and torch.equal(state, state2)


# --------------------------------------------------------------------------
# gradients: the forward is the kernel, the backward the plain version's
# --------------------------------------------------------------------------


def _grads(fn, inputs, seed=9):
    """d(sum(out * w))/d(inputs) for a fixed random w per output."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator(device=inputs[0].device).manual_seed(seed)
    total = sum((o.float() * torch.randn(o.shape, generator=g, device=o.device)).sum() for o in outs)
    return torch.autograd.grad(total, inputs)


def _leaves_on(shape_dtypes, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=device).to(_TDT[d]).requires_grad_()
                 for s, d in shape_dtypes)


def _same_grads(got, want, tol):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1024, 4096, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_grad_recomputes_plain(cuda_device, D, dtype):
    """One kernel launch forward; the gradients equal autograd through the
    plain version (the backward recomputes it: the same arithmetic)."""
    x, s = _leaves_on((((4, 37, D), dtype), ((D,), "float32")), cuda_device, seed=D)
    n = ops.LAUNCHES["rmsnorm"]
    got = _grads(lambda x, s: ops.rmsnorm(x, s), (x, s))
    assert ops.LAUNCHES["rmsnorm"] == n + 1
    _same_grads(got, _grads(lambda x, s: ref.rmsnorm_ref(x, s), (x, s)), 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", [("bfloat16", "mma_prefill"), ("float32", "fma")])
@pytest.mark.parametrize("G,window", [(8, None), (2, None), (8, 40)])
def test_flash_grad_recomputes_plain(cuda_device, dtype, route, G, window):
    """deepseek-7b's training call (self-attention over the sequence, H=8
    heads of 128 here) launches the route's kernel once; q, k and v get the
    gradient of the fp32 plain function."""
    B, S, H, K = 2, 200, 8, 128
    q, k, v = _leaves_on((((B, S, H, K), dtype), ((B, S, G, K), dtype), ((B, S, G, K), dtype)),
                         cuda_device, seed=G)
    pos = torch.arange(S, dtype=torch.int32, device=cuda_device)
    n = ops.FLASH_ROUTES[route]
    got = _grads(lambda q, k, v: ops.flash_attention(q, k, v, pos, pos, True, window), (q, k, v))
    assert ops.FLASH_ROUTES[route] == n + 1
    want = _grads(lambda q, k, v: ref.flash_attention_ref(q, k, v, pos, pos, True, window), (q, k, v))
    _same_grads(got, want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route,P,N,chunk", [
    ("bfloat16", "mma", 64, 128, 128),  # mamba2-370m's call
    ("float32", "fma", 16, 16, 16),  # the reduced config's
])
@pytest.mark.parametrize("use_state", [False, True])
def test_ssd_grad_recomputes_plain_through_views(cuda_device, dtype, route, P, N, chunk, use_state):
    """x, B and C as strided views of one xBC tensor, as the Mamba block
    passes them: one launch of the route's kernel; xBC (through the
    views), dt and A get the gradient of the plain chunked scan, with or
    without a gradient for the final state."""
    B, S, H = 2, 300, 4
    (xbc,) = _leaves_on((((B, S, H * P + 2 * N), dtype),), cuda_device, seed=P)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    dt = (torch.rand(B, S, H, generator=gen, device=cuda_device) * 0.099 + 0.001).requires_grad_()
    A = (-(torch.rand(H, generator=gen, device=cuda_device) * 3.5 + 0.5)).requires_grad_()

    def run(scan):
        def fn(xbc, dt, A):
            x = xbc[..., : H * P].view(B, S, H, P)
            y, state = scan(x, dt, A, xbc[..., H * P : H * P + N], xbc[..., H * P + N :])
            return (y, state) if use_state else y
        return fn

    n = ops.SSD_ROUTES[route]
    got = _grads(run(lambda *a: ops.ssd_scan(*a, chunk, out_dtype=torch.float32)), (xbc, dt, A))
    assert ops.SSD_ROUTES[route] == n + 1
    want = _grads(run(lambda *a: ref.ssd_chunked_ref(*a, chunk)), (xbc, dt, A))
    _same_grads(got, want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-370m"])
def test_train_step_loss_and_grads_match_cpu(cuda_device, arch):
    """A small float32 model (head_dim 64; the reduced SSD sizes) on the
    card through the kernels against the CPU plain path: loss within 1e-5
    relative, each grad leaf within 1e-4 of its largest element; the step
    launches 4L+1 RMSNorm and 2L attention or SSD kernels (forward and
    the remat recompute)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import Model
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import leaves_with_paths, tree_map

    cfg = reduced_config(arch, head_dim=64)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device=cuda_device)
    params = cpu.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 41), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ops.reset_launches()
    lg, _, gg = loss_and_grads(gpu, tree_map(lambda t: t.to(cuda_device), params),
                               {k: v.to(cuda_device) for k, v in batch.items()})
    L = cfg.n_layers
    mixer = "flash_attention" if arch == "deepseek-7b" else "ssd_scan"
    assert ops.LAUNCHES == {"rmsnorm": 4 * L + 1, "flash_attention": 0, "ssd_scan": 0, mixer: 2 * L}
    lc, _, gc = loss_and_grads(cpu, params, batch)
    assert lg.item() == pytest.approx(lc.item(), rel=1e-5)
    want = dict(leaves_with_paths(gc))
    for key, g in leaves_with_paths(gg):
        torch.testing.assert_close(g.cpu(), want[key], atol=1e-4 * want[key].abs().max().item(), rtol=0)


# The vlm, audio and sliding-window families' widths: head_dim 80
# (hubert-xlarge, non-causal) and 120 (h2o-danube-3-4b, a 4096-key window),
# and granite-34b's MQA (48 query heads on one KV head)


_ROUTE_ARGS = {  # route: (dtype, Sq)
    "fma": ("float32", 37), "mma_prefill": ("bfloat16", 37),
    "decode_f32": ("float32", 1), "decode_bf16": ("bfloat16", 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("K", [64, 80, 120, 128])
@pytest.mark.parametrize("mask", ["causal", "non_causal", "window", "window_non_causal"])
@pytest.mark.parametrize("route", list(_ROUTE_ARGS))
def test_flash_head_dims_masks_every_route(cuda_device, route, mask, K):
    """Every route at every head dim, causal or not, with or without a
    window, over a cache whose queries sit at its end and middle (decode:
    per-row positions), on the route _flash_route names."""
    dtype, Sq = _ROUTE_ARGS[route]
    B, T, H, G = 2, 150, 8, 2
    causal, window = "non_causal" not in mask, 40 if "window" in mask else None
    gen = torch.Generator(device=cuda_device).manual_seed(K + Sq)
    q = torch.randn(B, Sq, H, K, generator=gen, device=cuda_device).to(_TDT[dtype])
    k, v = _kv(B, T, G, K, dtype, cuda_device, seed=K)
    kpos = torch.arange(T, dtype=torch.int32, device=cuda_device)
    if Sq == 1:
        qpos = torch.tensor([[T - 1], [70]], dtype=torch.int32, device=cuda_device)
    else:
        qpos = torch.arange(T - Sq, T, dtype=torch.int32, device=cuda_device)
    name = ops._flash_route(Sq, _TDT[dtype])
    n = ops.FLASH_ROUTES[name]
    out = ops.flash_attention(q, k, v, qpos, kpos, causal, window)
    torch.cuda.synchronize()
    assert ops.FLASH_ROUTES[name] == n + 1 and out.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, causal, window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hubert", "h2o_prefill", "h2o_decode_wrapped"])
def test_flash_family_shapes(cuda_device, case):
    """The full-width paths' own calls: hubert-xlarge's non-causal prefill
    (B=8, S=500, 16 heads of 80), h2o-danube-3-4b's windowed prefill of two
    windows (S=8192, window 4096, 32 on 8 heads of 120), and its decode
    over the 4096-slot ring after 16 tokens wrapped over slots 0-15."""
    if case == "hubert":
        B, Sq, T, H, G, K, causal, window = 8, 500, 500, 16, 16, 80, False, None
    elif case == "h2o_prefill":
        B, Sq, T, H, G, K, causal, window = 1, 8192, 8192, 32, 8, 120, True, 4096
    else:
        B, Sq, T, H, G, K, causal, window = 1, 1, 4096, 32, 8, 120, True, 4096
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    q = torch.randn(B, Sq, H, K, generator=gen, device=cuda_device).bfloat16()
    k, v = _kv(B, T, G, K, "bfloat16", cuda_device, seed=22)
    if case == "h2o_decode_wrapped":
        slots = torch.arange(T, dtype=torch.int32, device=cuda_device)
        kpos = torch.where(slots < 16, slots + 8192, slots + 4096)  # 8192..8207, then 4112..8191
        qpos = torch.tensor([8207], dtype=torch.int32, device=cuda_device)
    else:
        kpos = torch.arange(T, dtype=torch.int32, device=cuda_device)
        qpos = kpos
    out = ops.flash_attention(q, k, v, qpos, kpos, causal, window)
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, causal, window)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq", [1, 5, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_mqa_one_kv_head(cuda_device, Sq, dtype):
    """granite-34b's attention: 48 query heads on G = 1 KV head of 128, a
    decode step at per-row positions and prefills, on every route."""
    B, T, H, G, K = 2, 256, 48, 1, 128
    gen = torch.Generator(device=cuda_device).manual_seed(Sq + 31)
    q = torch.randn(B, Sq, H, K, generator=gen, device=cuda_device).to(_TDT[dtype])
    k, v = _kv(B, T, G, K, dtype, cuda_device, seed=32)
    kpos = torch.arange(T, dtype=torch.int32, device=cuda_device)
    if Sq == 1:
        qpos = torch.tensor([[255], [100]], dtype=torch.int32, device=cuda_device)
    else:
        qpos = torch.arange(T - Sq, T, dtype=torch.int32, device=cuda_device)
    out = ops.flash_attention(q, k, v, qpos, kpos, True, None)
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, True, None)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,head_dim", [("llava-next-mistral-7b", 128), ("hubert-xlarge", 80)])
def test_vlm_and_audio_inputs_on_card_match_cpu(cuda_device, arch, head_dim):
    """Reduced llava-next-mistral-7b (image rows before the text) and
    hubert-xlarge (frames, non-causal, head_dim 80), fp32: the embedded
    inputs, the prefill logits (through the kernels on the card, the plain
    versions on the CPU) and the loss agree within 1e-4."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import Model
    from repro_torch.train.data import make_batch
    from repro_torch.tree import tree_map

    cfg = reduced_config(arch, head_dim=head_dim)
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device=cuda_device)
    p_cpu = cpu.init(torch.Generator().manual_seed(0))
    p_gpu = tree_map(lambda t: t.to(cuda_device), p_cpu)
    b = {k: torch.from_numpy(v) for k, v in make_batch(cfg, 2, 24, step=0).items()}
    b_gpu = {k: v.to(cuda_device) for k, v in b.items()}
    (h_c, n_c), (h_g, n_g) = cpu._embed_inputs(p_cpu, b), gpu._embed_inputs(p_gpu, b_gpu)
    assert n_c == n_g == (cfg.vlm_img_tokens if cfg.family == "vlm" else 0)
    torch.testing.assert_close(h_g.cpu(), h_c, atol=1e-5, rtol=1e-5)
    inputs = {k: v for k, v in b.items() if k != "labels"}
    l_c, _ = cpu.prefill(p_cpu, inputs, cpu.init_cache(2, 32))
    n = ops.LAUNCHES["flash_attention"]
    l_g, _ = gpu.prefill(p_gpu, {k: v.to(cuda_device) for k, v in inputs.items()},
                         gpu.init_cache(2, 32))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == n + cfg.n_layers
    torch.testing.assert_close(l_g.cpu(), l_c, atol=1e-4, rtol=1e-4)
    loss_c, loss_g = cpu.loss(p_cpu, b)[0], gpu.loss(p_gpu, b_gpu)[0]
    torch.testing.assert_close(loss_g.cpu(), loss_c, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# DTensors on a one-rank mesh, and the meta device
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank_mesh():
    """A (1, 1) ("data", "model") cuda mesh on a one-rank NCCL group (a
    FileStore: no network), destroyed after the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: NCCL and the kernels run on the card")
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1, device_id=torch.device("cuda", 0))
        try:
            yield init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        finally:
            dist.destroy_process_group()


def _route_inputs(route, dev):
    """(wrapper, plain-tensor args, kwargs) of one kernel route on the card."""
    gen = torch.Generator(device=dev).manual_seed(7)
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(s, generator=gen, device=dev).to(dt)  # noqa: E731
    if route.startswith("rmsnorm"):
        D = 4096 if route == "rmsnorm row" else 1000
        return ops.rmsnorm, (rnd(4, 8, D), rnd(D, dt=torch.float32)), {}
    if route.startswith("flash"):
        Sq = 1 if route == "flash decode" else 64
        dt = torch.float32 if route == "flash fma" else torch.bfloat16
        pos = torch.arange(64, dtype=torch.int32, device=dev)
        return ops.flash_attention, (rnd(2, Sq, 8, 128, dt=dt), rnd(2, 64, 2, 128, dt=dt),
                                     rnd(2, 64, 2, 128, dt=dt), pos[64 - Sq:], pos), {}
    dt = torch.float32 if route == "ssd fma" else torch.bfloat16
    return ops.ssd_scan, (rnd(2, 256, 4, 64, dt=dt), torch.rand(2, 256, 4, generator=gen, device=dev),
                          -torch.rand(4, generator=gen, device=dev), rnd(2, 256, 128, dt=dt),
                          rnd(2, 256, 128, dt=dt), 128), {}


ROUTES = ["rmsnorm row", "rmsnorm general", "flash decode", "flash mma_prefill", "flash fma",
          "ssd mma", "ssd fma"]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_dtensor_forward_equals_plain_bit_for_bit(one_rank_mesh, route):
    """Each route on replicated DTensors of a (1, 1) mesh: one launch
    through the DTensor branch (local_map), the same bits as on the plain
    tensors."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    fn, args, kw = _route_inputs(route, torch.device("cuda"))
    want = fn(*args, **kw)
    placed = [distribute_tensor(a, one_rank_mesh) if torch.is_tensor(a) and a.ndim and
              not (fn is ops.flash_attention and a.dtype == torch.int32) else a for a in args]
    n, calls = dict(ops.LAUNCHES), dict(ops.DTENSOR_CALLS)
    got = fn(*placed, **kw)
    torch.cuda.synchronize()
    name = {ops.rmsnorm: "rmsnorm", ops.flash_attention: "flash_attention", ops.ssd_scan: "ssd_scan"}[fn]
    assert ops.LAUNCHES[name] == n[name] + 1 and ops.DTENSOR_CALLS[name] == calls[name] + 1
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert isinstance(g, DTensor)
        assert torch.equal(g.to_local(), w), route


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_meta_branch_gives_the_kernels_shapes(cuda_device, route):
    """On meta copies of the inputs each wrapper returns what the kernel
    returns, in shape and dtype, and launches and counts nothing."""
    fn, args, kw = _route_inputs(route, cuda_device)
    want = fn(*args, **kw)
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    n = dict(ops.LAUNCHES)
    got = fn(*meta, **kw)
    assert ops.LAUNCHES == n
    for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype, route


@pytest.mark.cuda
def test_expert_parallel_moe_at_model_one_equals_apply_moe(one_rank_mesh):
    """apply_moe_shard_map with one model rank: the output and aux of
    apply_moe bit for bit, in bf16, some pairs dropped; grads finite."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import reduced_config
    from repro_torch.models import moe

    cfg = reduced_config("qwen3-moe-30b-a3b", dtype="bfloat16", capacity_factor=0.5)
    dev = torch.device("cuda")
    p = moe.init_moe(torch.Generator(device=dev).manual_seed(0), cfg)
    x = torch.randn(2, 37, cfg.d_model, generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev).to(torch.bfloat16)
    y, aux = moe.apply_moe(p, cfg, x)
    dp = {k: distribute_tensor(v, one_rank_mesh).requires_grad_() for k, v in p.items()}
    dy, daux = moe.apply_moe_shard_map(dp, cfg, distribute_tensor(x, one_rank_mesh), one_rank_mesh, None)
    assert torch.equal(dy.to_local(), y) and torch.equal(daux.to_local(), aux)
    assert not moe.route(p["router"], cfg, x.reshape(-1, cfg.d_model)).keep.all()
    grads = torch.autograd.grad(dy.to_local().float().sum() + daux.to_local(), list(dp.values()))
    assert all(bool(g.to_local().isfinite().all()) for g in grads)
