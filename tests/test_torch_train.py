"""The port's training against the JAX package's, on reduced deepseek-7b
and mamba2-370m in float32 with the JAX-initialised weights passed through
convert.params_from_jax: Model.loss and its grads at step 0, make_train_step
trajectories (plain, two microbatches, int8 compression), and
microbatching against one batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro.train.data import make_batch as j_make_batch  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tts  # noqa: E402
from repro_torch.tree import leaves, leaves_with_paths  # noqa: E402

ARCHS = ["deepseek-7b", "mamba2-370m"]
B, S = 4, 24  # S = 24: one full SSD chunk of 16 and a tail
OPT = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    arch = request.param
    jcfg = j_reduced_config(arch)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = reduced_config(arch)
    return jcfg, jm, jp, cfg, Model(cfg, device="cpu")


def _tp(jp, cfg):
    """Fresh port params from the JAX params (the train step updates
    them in place)."""
    return params_from_jax(jax.tree.map(np.asarray, jp), cfg)


def _batch(jcfg, step, mask_some=False):
    b = j_make_batch(jcfg, B, S, step=step, seed=0)
    if mask_some:  # ignored positions: labels of -1
        b["labels"][0, :5] = -1
        b["labels"][2, 10:] = -1
    return b


def _paths(tree):
    return dict(leaves_with_paths(jax.tree.map(np.asarray, tree)))


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[1, 2:] = -1
    for lab in (labels, np.full_like(labels, -1)):  # all ignored: count clamps to 1
        xj, nj = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(lab))
        xt, nt = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab))
        assert xt.dtype == torch.float32
        np.testing.assert_allclose(xt.item(), float(xj), rtol=1e-6)
        assert nt.item() == float(nj)


def test_loss_and_grads_match_jax(pair):
    """Step 0: loss within 1e-5 relative, each grad leaf within 1e-4 of
    its largest element (float32; XLA and torch sum in other orders)."""
    jcfg, jm, jp, cfg, tm = pair
    b = _batch(jcfg, 0, mask_some=True)
    (lj, mj), gj = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()}
    )
    lt, mt, gt = tts.loss_and_grads(tm, _tp(jp, cfg), {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-5)
    assert mt["n_tokens"].item() == float(mj["n_tokens"]) == B * S - 5 - (S - 10)
    assert mt["aux"].item() == float(mj["aux"]) == 0.0
    want = _paths(gj)
    got = dict(leaves_with_paths(gt))
    assert set(got) == set(want)
    for key, g in got.items():
        ref = want[key]
        assert g.shape == ref.shape and g.dtype == torch.float32, key
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (key, err, np.abs(ref).max())


def _lr_sum(steps):
    cfg = topt.AdamWConfig(**OPT)
    return sum(float(topt.cosine_lr(cfg, torch.tensor(s + 1))) for s in range(steps))


@pytest.mark.parametrize("variant", ["plain", "microbatches", "compress"])
def test_train_trajectory_matches_jax(pair, variant):
    """Five make_train_step steps from the same weights and batches.

    Losses agree within 1e-5 relative at every step, and so do grad norms
    except under compression (below).  A param moves by
    lr * mhat / sqrt(vhat), which is about +-lr wherever the gradient is
    tiny, so an element whose gradient is within float noise of 0 may
    step the other way in the other package: no element
    may differ by more than 2 * sum(lr) (the bound), and at most a 1e-3
    share of a leaf's elements by more than 1e-5.  With int8 compression
    an element within float noise of a rounding boundary may also take
    the other int8 value (one quantum, absmax/127 of its leaf, of its
    gradient), so there the share is 1e-2 and the grad norm, taken of the
    quantized gradient, agrees within 1e-3 relative."""
    jcfg, jm, jp, cfg, tm = pair
    mb, comp = {"plain": (1, False), "microbatches": (2, False), "compress": (1, True)}[variant]
    jstep = jax.jit(jts.make_train_step(jm, jopt.AdamWConfig(**OPT), mb, comp))
    tstep = tts.make_train_step(tm, topt.AdamWConfig(**OPT), mb, comp)
    js = jts.TrainState(jp, jopt.adamw_init(jp), jopt.zeros_like_error(jp) if comp else None)
    tp = _tp(jp, cfg)
    ts = tts.TrainState(tp, topt.adamw_init(tp), topt.zeros_like_error(tp) if comp else None)
    steps = 5
    for i in range(steps):
        b = _batch(jcfg, i)
        js, jm_ = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm_ = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        for name in ("loss", "xent", "grad_norm", "lr"):
            rtol = 1e-3 if comp and name == "grad_norm" else 1e-5
            np.testing.assert_allclose(tm_[name].item(), float(jm_[name]), rtol=rtol,
                                       err_msg=f"{name} step {i}")
    assert ts.opt.step.item() == int(js.opt.step) == steps
    bound = 2 * _lr_sum(steps)
    share = 1e-2 if comp else 1e-3
    want = _paths(js.params)
    for key, p in leaves_with_paths(ts.params):
        err = np.abs(p.numpy() - want[key])
        assert err.max() <= bound, (key, err.max(), bound)
        assert np.mean(err > 1e-5) <= share, (key, np.mean(err > 1e-5))
    assert not any(p.requires_grad for p in leaves(ts.params))


def test_microbatches_equal_one_batch(pair):
    """Two microbatches of 2 rows against one batch of 4: loss, grad norm
    and the first moment (0.1 x the clipped gradient) within 1e-5."""
    jcfg, _, jp, cfg, tm = pair
    b = {k: torch.from_numpy(v) for k, v in _batch(jcfg, 0).items()}
    out = []
    for mb in (1, 2):
        tp = _tp(jp, cfg)
        step = tts.make_train_step(tm, topt.AdamWConfig(**OPT), num_microbatches=mb)
        out.append(step(tts.TrainState(tp, topt.adamw_init(tp)), b))
    (s1, m1), (s2, m2) = out
    for name in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose(m2[name].item(), m1[name].item(), rtol=1e-5)
    # the metrics are means over microbatches, n_tokens too (as in JAX)
    assert m2["n_tokens"].item() * 2 == m1["n_tokens"].item() == B * S
    for a, c in zip(leaves(s2.opt.m), leaves(s1.opt.m)):
        assert (a - c).abs().max().item() <= 1e-5 * c.abs().max().item()
    with pytest.raises(ValueError, match="microbatches"):
        tts.make_train_step(tm, topt.AdamWConfig(**OPT), num_microbatches=3)(s1, b)


def test_train_state_template_is_meta(pair):
    _, _, jp, cfg, tm = pair
    tmpl = tts.train_state_template(tm, compress_grads=True)
    real = tts.TrainState(_tp(jp, cfg), topt.adamw_init(_tp(jp, cfg)),
                          topt.zeros_like_error(_tp(jp, cfg)))
    got, want = leaves_with_paths(tmpl), leaves_with_paths(real)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, c) in zip(got, want):
        assert a.device.type == "meta" and a.shape == c.shape and a.dtype == c.dtype
