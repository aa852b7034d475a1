"""The port's AdamW, schedule and int8 compression against the JAX
package's (the cases of tests/test_optimizer.py, each held against the
JAX functions on the same inputs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402


def _t(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def _close(t, j, tol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=tol, atol=tol)


def test_converges_on_quadratic():
    """150 steps on (w - target)^2, both packages: the same path and the
    same end point, at the target."""
    kw = dict(lr_peak=0.1, warmup_steps=5, total_steps=200, weight_decay=0.0)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jp = {"w": jnp.array([5.0, -3.0])}
    tp = _t(jp)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    target = np.array([1.0, 2.0], np.float32)
    for _ in range(150):
        jp, js, _ = jopt.adamw_update(jcfg, jp, {"w": 2 * (jp["w"] - target)}, js)
        tp, ts, _ = topt.adamw_update(tcfg, tp, {"w": 2 * (tp["w"] - torch.from_numpy(target))}, ts)
    _close(tp["w"], jp["w"], 1e-5)
    np.testing.assert_allclose(tp["w"].numpy(), target, atol=0.05)
    assert ts.step.dtype == torch.int32 and ts.step.item() == int(js.step) == 150


def test_clip_bounds_update():
    kw = dict(clip_norm=1.0, lr_peak=1.0, warmup_steps=0, total_steps=10, weight_decay=0.0)
    jp = {"w": jnp.zeros(3)}
    huge = {"w": jnp.array([1e6, 1e6, 1e6])}
    jnew, jst, jm = jopt.adamw_update(jopt.AdamWConfig(**kw), jp, huge, jopt.adamw_init(jp))
    tp = _t(jp)
    tnew, tst, tm = topt.adamw_update(topt.AdamWConfig(**kw), tp, _t(huge), topt.adamw_init(tp))
    assert float(tm["grad_norm"]) > 1e6  # raw norm reported
    _close(tm["grad_norm"], jm["grad_norm"])
    _close(tnew["w"], jnew["w"])
    _close(tst.m["w"], jst.m["w"])  # post-clip grad of norm 1
    _close(tst.v["w"], jst.v["w"])


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_cosine_schedule_matches_jax(step):
    kw = dict(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    got = topt.cosine_lr(topt.AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32))
    want = jopt.cosine_lr(jopt.AdamWConfig(**kw), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-12)


def test_cosine_schedule_endpoints():
    cfg = topt.AdamWConfig(lr_peak=1e-3, warmup_steps=10, total_steps=100)
    assert float(topt.cosine_lr(cfg, torch.tensor(0))) == pytest.approx(0.0)
    assert float(topt.cosine_lr(cfg, torch.tensor(10))) == pytest.approx(1e-3)
    assert float(topt.cosine_lr(cfg, torch.tensor(100))) == pytest.approx(0.0, abs=1e-9)


def test_weight_decay_only_on_matrices():
    kw = dict(lr_peak=0.1, warmup_steps=0, total_steps=10, weight_decay=1.0)
    jp = {"mat": jnp.ones((2, 2)), "scale": jnp.ones((4,))}
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jnew, _, _ = jopt.adamw_update(jopt.AdamWConfig(**kw), jp, zeros, jopt.adamw_init(jp))
    tp = _t(jp)
    tnew, _, _ = topt.adamw_update(topt.AdamWConfig(**kw), tp, _t(zeros), topt.adamw_init(tp))
    assert float(tnew["mat"].abs().max()) < 1.0  # decayed
    np.testing.assert_allclose(tnew["scale"].numpy(), 1.0)  # exempt
    _close(tnew["mat"], jnew["mat"])


@pytest.mark.parametrize("arch", ["deepseek-7b", "mamba2-370m"])
def test_decay_rule_on_the_stacked_tree(arch):
    """The reference decays every leaf with ndim >= 2, which in the
    stacked tree is every per-block leaf (norm scales and Mamba's A_log,
    D, dt_bias, conv_b and norm too): only final_norm is exempt.  One step
    with zero grads moves exactly the decayed leaves, in both packages."""
    cfg = j_reduced_config(arch)
    # + 1: no leaf is zero (conv_b starts at 0, where decay moves nothing)
    jp = jax.tree.map(lambda a: a + 1, JModel(cfg).init(jax.random.PRNGKey(0)))
    kw = dict(lr_peak=0.1, warmup_steps=0, total_steps=10, weight_decay=0.5)
    zeros = jax.tree.map(jnp.zeros_like, jp)
    jnew, _, _ = jopt.adamw_update(jopt.AdamWConfig(**kw), jp, zeros, jopt.adamw_init(jp))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), reduced_config(arch))
    before = dict(leaves_with_paths(jax.tree.map(np.asarray, jp)))
    tnew, _, _ = topt.adamw_update(topt.AdamWConfig(**kw), tp, jax.tree.map(
        lambda a: torch.zeros(a.shape), zeros), topt.adamw_init(tp))
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jnew)))
    moved = set()
    for key, p in leaves_with_paths(tnew):
        _close(p.numpy(), want[key])
        if not np.array_equal(p.numpy(), before[key]):
            moved.add(key)
    exempt = {k for k in before if k not in moved}
    assert exempt == {"final_norm"}, exempt
    if arch == "mamba2-370m":
        assert {f"blocks/sub0/mamba/{n}" for n in ("A_log", "D", "dt_bias", "conv_b", "norm")} <= moved
    assert "blocks/sub0/ln1" in moved


def test_global_norm():
    tree = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(topt.global_norm(tree)) == pytest.approx(5.0)
    rng = np.random.default_rng(2)
    jt = {"x": jnp.asarray(rng.normal(size=(5, 7)), jnp.bfloat16),
          "y": {"z": jnp.asarray(rng.normal(size=(11,)), jnp.float32)}}
    tt = {"x": torch.tensor(np.asarray(jt["x"], np.float32)).bfloat16(),
          "y": {"z": torch.tensor(np.asarray(jt["y"]["z"]))}}
    _close(topt.global_norm(tt), jopt.global_norm(jt))


class TestCompression:
    def test_roundtrip_matches_jax(self):
        rng = np.random.default_rng(0)
        g = rng.normal(size=(1000,)).astype(np.float32)
        qj, sj = jopt.compress(jnp.asarray(g))
        qt, st = topt.compress(torch.from_numpy(g))
        assert qt.dtype == torch.int8
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        assert st.item() == float(sj)
        back = topt.decompress(qt, st)
        np.testing.assert_array_equal(back.numpy(), np.asarray(jopt.decompress(qj, sj)))
        assert float((back - torch.from_numpy(g)).abs().max()) <= st.item() / 2 + 1e-6

    def test_round_half_to_even(self):
        """Values that land exactly on k + 1/2 quanta round to the even k,
        in both packages."""
        g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)
        qj, _ = jopt.compress(jnp.asarray(g))
        qt, _ = topt.compress(torch.from_numpy(g))
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(qt.numpy()[1:], [0, 2, 2, 0, -2, 4])

    def test_error_feedback_matches_jax(self):
        """50 steps of compression with error feedback: the same grads_hat
        and residuals as JAX, and the accumulated sum stays within a few
        quanta of the true sum."""
        rng = np.random.default_rng(1)
        seq = [rng.normal(size=(64,)).astype(np.float32) for _ in range(50)]
        je = jopt.zeros_like_error({"w": jnp.zeros(64)})
        te = topt.zeros_like_error({"w": torch.zeros(64)})
        acc_hat = torch.zeros(64)
        for g in seq:
            jg, je = jopt.compress_decompress_with_feedback({"w": jnp.asarray(g)}, je)
            tg, te = topt.compress_decompress_with_feedback({"w": torch.from_numpy(g)}, te)
            _close(tg["w"], jg["w"])
            _close(te["w"], je["w"])
            acc_hat += tg["w"]
        resid = float((acc_hat - torch.from_numpy(np.sum(seq, axis=0))).abs().max())
        assert resid < float(np.abs(seq[0]).max()) / 127 * 4

    def test_keeps_grad_dtypes(self):
        grads = {"a": torch.randn(8).bfloat16(), "b": torch.randn(3, 3)}
        ghat, err = topt.compress_decompress_with_feedback(grads, topt.zeros_like_error(grads))
        assert ghat["a"].dtype == torch.bfloat16 and ghat["b"].dtype == torch.float32
        assert err["a"].dtype == err["b"].dtype == torch.float32
