"""The gradients of the kernel wrappers, on the CPU.

On the card each wrapper in ``kernels.ops`` is an ``autograd.Function``
whose forward launches the kernel and whose backward recomputes and
differentiates the plain version.  Here the kernels are swapped for their
plain versions (which count their calls), so the Functions' plumbing is
held against autograd straight through the plain versions: saved inputs,
strided SSD views, a final state with no gradient, and the launches a
training step makes under remat.  The kernels themselves are held on the
card by tests/test_torch_kernels_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.train.train_step import loss_and_grads  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402


@pytest.fixture
def plain_kernels(monkeypatch):
    """Route every CPU call through the Functions, with each kernel
    replaced by its plain version; returns the count of forward calls."""
    calls = {"rmsnorm": 0, "flash_attention": 0, "ssd_scan": 0}

    def rms(x, scale, eps):
        calls["rmsnorm"] += 1
        return ref.rmsnorm_ref(x, scale, eps)

    def flash(q, k, v, q_pos, kv_pos, causal, window):
        calls["flash_attention"] += 1
        return ref.flash_attention_ref(q, k, v, q_pos, kv_pos, causal, window)

    def ssd(x, dt, A, Bm, Cm, chunk, init_state, out_dtype):
        calls["ssd_scan"] += 1
        y, state = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, chunk, init_state)
        return y.to(out_dtype), state

    monkeypatch.setattr(ops, "_on_cpu", lambda *t: False)
    monkeypatch.setattr(ops, "_rmsnorm_kernel", rms)
    monkeypatch.setattr(ops, "_flash_attention_kernel", flash)
    monkeypatch.setattr(ops, "_ssd_scan_kernel", ssd)
    return calls


def _leaf(*shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).requires_grad_()


def _grads(fn, inputs, seed=9):
    """d(sum(out * w))/d(inputs) for a fixed random w per output."""
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator().manual_seed(seed)
    total = sum((o.float() * torch.randn(o.shape, generator=g)).sum() for o in outs)
    return torch.autograd.grad(total, inputs)


def _same_grads(a, b, tol=1e-6):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        torch.testing.assert_close(x, y, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_function_grads(plain_kernels, dtype):
    x, s = _leaf(3, 5, 64, dtype=dtype), _leaf(64, seed=1)
    got = _grads(lambda x, s: ops.rmsnorm(x, s), (x, s))
    _same_grads(got, _grads(lambda x, s: ref.rmsnorm_ref(x, s), (x, s)))
    assert plain_kernels["rmsnorm"] == 1  # one forward; the backward is the plain version's


@pytest.mark.parametrize("G,window", [(4, None), (2, None), (2, 5)])
def test_flash_function_grads(plain_kernels, G, window):
    q, k, v = _leaf(2, 9, 4, 16), _leaf(2, 9, G, 16, seed=1), _leaf(2, 9, G, 16, seed=2)
    pos = torch.arange(9, dtype=torch.int32)
    got = _grads(lambda q, k, v: ops.flash_attention(q, k, v, pos, pos, True, window), (q, k, v))
    want = _grads(lambda q, k, v: ref.flash_attention_ref(q, k, v, pos, pos, True, window), (q, k, v))
    _same_grads(got, want)


@pytest.mark.parametrize("use_state", [False, True])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_function_grads_through_strided_views(plain_kernels, use_state, init):
    """x, B and C as the model passes them: strided views of one xBC
    tensor.  The gradient of xBC (through the views), dt, A and the
    initial state equals autograd through the plain version, whether or
    not the final state is used."""
    Bsz, S, H, P, N = 2, 21, 3, 16, 16
    xbc = _leaf(Bsz, S, H * P + 2 * N)
    dt = torch.rand((Bsz, S, H), generator=torch.Generator().manual_seed(3)).requires_grad_()
    A = (-torch.rand(H, generator=torch.Generator().manual_seed(4)) - 0.5).requires_grad_()
    h0 = _leaf(Bsz, H, N, P, seed=5) if init else None

    def run(scan):
        def fn(xbc, dt, A, *h):
            xh = xbc[..., : H * P].view(Bsz, S, H, P)
            Bm, Cm = xbc[..., H * P : H * P + N], xbc[..., H * P + N :]
            y, state = scan(xh, dt, A, Bm, Cm, h[0] if h else None)
            return (y, state) if use_state else y
        return fn

    inputs = (xbc, dt, A) + ((h0,) if init else ())
    got = _grads(run(lambda *a: ops.ssd_scan(*a[:5], 16, init_state=a[5], out_dtype=torch.float32)), inputs)
    want = _grads(run(lambda *a: ref.ssd_chunked_ref(*a[:5], 16, a[5])), inputs)
    _same_grads(got, want, tol=1e-5)


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-370m"])
def test_model_grads_through_the_functions(plain_kernels, arch):
    """Model.loss and every grad leaf through the Functions equal the plain
    path's (grads within 1e-5 of each leaf's largest element: the
    recompute adds its gradients into the graph in another order), and
    every leaf gets one (Mamba's in_proj and conv_w through the strided
    SSD views).  The forward kernels run 4L+1 RMSNorm and 2L attention or
    SSD scans a step: the forward, then each block's recompute under
    remat; the final norm is outside it."""
    cfg = reduced_config(arch)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 25)).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, _, grads = loss_and_grads(model, params, batch)
    L = cfg.n_layers
    mixer = "ssd_scan" if arch == "mamba2-370m" else "flash_attention"
    assert plain_kernels == {"rmsnorm": 4 * L + 1, "flash_attention": 0, "ssd_scan": 0, mixer: 2 * L}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "_on_cpu", lambda *t: True)
        loss_p, _, grads_p = loss_and_grads(model, params, batch)
    assert loss.item() == pytest.approx(loss_p.item(), rel=1e-6)
    plain = dict(leaves_with_paths(grads_p))
    for key, g in leaves_with_paths(grads):
        torch.testing.assert_close(g, plain[key], atol=1e-5 * plain[key].abs().max().item(), rtol=0)
        assert g.abs().max() > 0, key


def test_mamba_views_stay_strided(plain_kernels, monkeypatch):
    """apply_mamba hands the scan strided views of xBC, and the Function
    saves those same views for its backward."""
    cfg = reduced_config("mamba2-370m")
    p = M.init_mamba(torch.Generator().manual_seed(0), cfg)
    seen = []
    orig = ops._SSDScan.forward

    def forward(ctx, x, *rest):
        seen.append(x.is_contiguous())
        return orig(ctx, x, *rest)

    monkeypatch.setattr(ops._SSDScan, "forward", staticmethod(forward))
    x = torch.randn(2, 20, cfg.d_model, requires_grad=True)
    M.apply_mamba(p, cfg, x).sum().backward()
    assert seen == [False] and x.grad.abs().max() > 0
