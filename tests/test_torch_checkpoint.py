"""The port's checkpoints against the JAX package's: the same on-disk
layout and keys, so a checkpoint from either package restores in the
other bit for bit; bfloat16 leaves stored as |V2 (which the JAX package's
own restore cannot read: ROADMAP.md, C2); latest/prune, torn writes, the
async writer, and the training driver's fail-and-resume."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.train_step import init_train_state as j_init_train_state  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    init_train_state,
    make_train_step,
    train_state_template,
)
from repro_torch.tree import leaves_with_paths  # noqa: E402


def _jax_state(arch, compress=False, **overrides):
    cfg = j_reduced_config(arch, **overrides)
    jm = JModel(cfg)
    state = j_init_train_state(jm, jax.random.PRNGKey(0), compress_grads=compress)
    template = jax.eval_shape(
        lambda k: j_init_train_state(jm, k, compress_grads=compress), jax.random.PRNGKey(0)
    )
    return state, template


def _port_state(arch, compress=False, **overrides):
    """A port TrainState after one step, so the moments are not zero."""
    model = Model(reduced_config(arch, **overrides), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(1), compress)
    step = make_train_step(model, AdamWConfig(warmup_steps=0), compress_grads=compress)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    state, _ = step(state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return model, state


def _bits(x):
    """The raw bytes of an array or tensor, with its shape and dtype
    name (bfloat16 from either package compares as the same bits)."""
    if torch.is_tensor(x):
        a = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
        name = "bfloat16" if x.dtype == torch.bfloat16 else a.dtype.name
    else:
        a = np.asarray(x)
        name = a.dtype.name
        a = a.view(np.int16) if name == "bfloat16" else a
    return a.shape, name, a.tobytes()


# qwen3-moe-30b-a3b: the fp32 router beside the experts
ARCHS = ["deepseek-7b", "mamba2-370m", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compress", [False, True])
def test_jax_checkpoint_restores_in_port(tmp_path, arch, compress):
    state, _ = _jax_state(arch, compress)
    jckpt.save(tmp_path, 7, state, {"loader": {"step": 7, "seed": 0}})
    model = Model(reduced_config(arch), device="cpu")
    got, meta = checkpoint.restore(tmp_path, train_state_template(model, compress), device="cpu")
    assert meta == {"step": 7, "loader": {"step": 7, "seed": 0}}
    want = jckpt._flatten(state)
    flat = leaves_with_paths(got)
    assert [k for k, _ in flat] == list(want)  # same keys, same order
    for key, t in flat:
        assert _bits(t) == _bits(want[key]), key
    assert got.opt.step.dtype == torch.int32 and (got.error_feedback is not None) == compress


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_jax(tmp_path, arch):
    _, state = _port_state(arch)
    checkpoint.save(tmp_path, 3, state)
    _, template = _jax_state(arch)
    restored, meta = jckpt.restore(tmp_path, template)
    assert meta["step"] == 3
    got = jckpt._flatten(restored)
    flat = leaves_with_paths(state)
    assert list(got) == [k for k, _ in flat]
    for key, t in flat:
        assert _bits(got[key]) == _bits(t), key


def test_jax_bf16_checkpoint_restores_in_port_only(tmp_path):
    """A bf16 TrainState saved by JAX: np.savez writes its params as |V2;
    the port restores them as the same bfloat16 bits.  The JAX package's
    own restore cannot cast |V2 to bfloat16 (ROADMAP.md, C2)."""
    state, template = _jax_state("deepseek-7b", dtype="bfloat16")
    jckpt.save(tmp_path, 1, state)
    with np.load(tmp_path / "step_1" / "arrays.npz") as arrays:
        assert arrays["params/embed/tokens"].dtype == np.dtype("V2")
    model = Model(reduced_config("deepseek-7b", dtype="bfloat16"), device="cpu")
    got, _ = checkpoint.restore(tmp_path, train_state_template(model), device="cpu")
    assert got.params["embed"]["tokens"].dtype == torch.bfloat16
    want = jckpt._flatten(state)
    for key, t in leaves_with_paths(got):
        assert _bits(t) == _bits(want[key]), key
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore(tmp_path, template)


def test_moe_bf16_checkpoint_restores_in_port(tmp_path):
    """A bf16 MoE TrainState, its router fp32 beside the bf16 experts:
    JAX's checkpoint restores in the port bit for bit, and so does the
    port's own (JAX's restore cannot read the |V2 experts: C2)."""
    arch, key = "qwen3-moe-30b-a3b", "params/blocks/sub0/moe/"
    state, _ = _jax_state(arch, dtype="bfloat16")
    jckpt.save(tmp_path / "jax", 1, state)
    with np.load(tmp_path / "jax" / "step_1" / "arrays.npz") as arrays:
        assert arrays[key + "router"].dtype == np.float32
        assert arrays[key + "w_up"].dtype == np.dtype("V2")
    model = Model(reduced_config(arch, dtype="bfloat16"), device="cpu")
    got, _ = checkpoint.restore(tmp_path / "jax", train_state_template(model), device="cpu")
    want = jckpt._flatten(state)
    for k, t in leaves_with_paths(got):
        assert _bits(t) == _bits(want[k]), k
    moe = got.params["blocks"]["sub0"]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["w_down"].dtype == torch.bfloat16
    _, stepped = _port_state(arch, dtype="bfloat16")
    checkpoint.save(tmp_path / "port", 2, stepped)
    again, meta = checkpoint.restore(tmp_path / "port", train_state_template(model), device="cpu")
    assert meta["step"] == 2
    for (k, x), (_, y) in zip(leaves_with_paths(again), leaves_with_paths(stepped)):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_port_bf16_file_has_jax_dtype_and_bytes(tmp_path):
    """The port writes a bfloat16 leaf as |V2 with the bytes JAX's save
    gives the same values, and reads it back."""
    state, _ = _jax_state("mamba2-370m", dtype="bfloat16")
    jckpt.save(tmp_path / "jax", 1, state)
    model = Model(reduced_config("mamba2-370m", dtype="bfloat16"), device="cpu")
    got, _ = checkpoint.restore(tmp_path / "jax", train_state_template(model), device="cpu")
    checkpoint.save(tmp_path / "port", 1, got)
    with np.load(tmp_path / "jax/step_1/arrays.npz") as a, \
            np.load(tmp_path / "port/step_1/arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    again, _ = checkpoint.restore(tmp_path / "port", train_state_template(model), device="cpu")
    for (k, x), (_, y) in zip(leaves_with_paths(again), leaves_with_paths(got)):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_restore_checks_the_template(tmp_path):
    model, state = _port_state("mamba2-370m")
    checkpoint.save(tmp_path, 2, state)
    tmpl = train_state_template(model)
    with pytest.raises(ValueError, match="device="):
        checkpoint.restore(tmp_path, tmpl)
    with pytest.raises(KeyError, match="error_feedback"):
        checkpoint.restore(tmp_path, train_state_template(model, compress_grads=True), device="cpu")
    small = Model(reduced_config("mamba2-370m", d_model=32), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(tmp_path, train_state_template(small), device="cpu")
    bf = Model(reduced_config("mamba2-370m", dtype="bfloat16"), device="cpu")
    checkpoint.save(tmp_path / "bf", 1, init_train_state(bf, torch.Generator().manual_seed(0)))
    with pytest.raises(TypeError, match="V2"):
        checkpoint.restore(tmp_path / "bf", tmpl, device="cpu")
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(tmp_path / "none", tmpl, device="cpu")


def test_latest_and_prune(tmp_path):
    _, state = _port_state("mamba2-370m")
    for s in (10, 20, 30, 40):
        checkpoint.save(tmp_path, s, state)
    assert checkpoint.latest_step(tmp_path) == 40
    checkpoint.prune(tmp_path, keep=2)
    assert checkpoint.latest_step(tmp_path) == 40
    assert not (tmp_path / "step_10").exists()
    assert (tmp_path / "step_30").exists()
    assert checkpoint.latest_step(tmp_path / "missing") is None


def test_incomplete_checkpoint_ignored(tmp_path):
    _, state = _port_state("mamba2-370m")
    checkpoint.save(tmp_path, 5, state)
    (tmp_path / "step_9").mkdir()  # a torn write: no commit marker
    (tmp_path / "step_11.tmp").mkdir()
    assert checkpoint.latest_step(tmp_path) == 5


def test_async_writer_copies_on_submit(tmp_path):
    """Three submits, pruned to two; each holds the state as it was at its
    submit, though the caller changes the tensors in place right after."""
    _, state = _port_state("mamba2-370m")
    w = checkpoint.AsyncWriter(tmp_path, keep=2)
    leaf = state.params["final_norm"]
    for s in (1, 2, 3):
        leaf.fill_(float(s))
        w.submit(s, state, {"loader": {"step": s, "seed": 0}})
        leaf.fill_(-1.0)
    w.close()
    assert checkpoint.latest_step(tmp_path) == 3
    assert not (tmp_path / "step_1").exists()
    for s in (2, 3):
        with np.load(tmp_path / f"step_{s}" / "arrays.npz") as a:
            np.testing.assert_array_equal(a["params/final_norm"], float(s))


def test_resume_is_exact(tmp_path):
    """Fail after step 6 of 10 (checkpoints every 4), resume from step 4:
    the final loss equals an uninterrupted run's, on the CPU."""
    kw = dict(steps=10, batch=2, seq=32, ckpt_every=4, log_every=100, device="cpu")
    d1 = str(tmp_path / "a")
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        train_loop("mamba2-370m", ckpt_dir=d1, fail_at=6, **kw)
    assert checkpoint.latest_step(d1) == 4
    resumed = train_loop("mamba2-370m", ckpt_dir=d1, **kw)
    straight = train_loop("mamba2-370m", ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed["final_step"] == straight["final_step"] == 10
    assert resumed["last_loss"] == straight["last_loss"]
    assert checkpoint.latest_step(d1) == 10


def test_train_loop_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop("mamba2-370m", steps=1)
