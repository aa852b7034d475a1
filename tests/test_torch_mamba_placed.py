"""The Mamba block on DTensors (``repro_torch/models/mamba.py``,
``_placed_mix`` and ``_gate_and_project``): its products and conv run on
`model`-split operands, as the reference's partitioner runs them.

``dryrun.run_cell`` of reduced jamba-1.5-large-398b and mamba2-370m at
``train_4k`` on a fake (data 4, model 2) mesh, under ``CostMode(by_op=True)``
(``tests/test_torch_dryrun.py``'s harness: bf16, head_dim 64; d_inner three
times d_model, 192, so that no other product of the step has the shapes
looked for), with every tensor the step makes recorded: no product has a
whole in_proj-shaped
``[D, Proj]`` or out_proj-shaped ``[d_inner, D]`` output (a weight
gradient computed unsplit), no activation is a whole ``[B, S, Proj]``
projection or a whole fp32 ``[B, S+k-1, Ch]`` conv input, and each
weight gradient of z's, x's and out_proj's blocks is its rank's slice.
Under ``sp`` (one dry run per arch, jamba cut to one super-block, shared
by the tests through a module fixture) the whole block runs on each
rank's sequence rows (``_rows_mix``, ``_gate_and_project_rows``), as the
reference's partitioner runs it: no ``[B, S, D]`` or ``[B, S, d_inner]``
tensor is made by the block, the gated rows are ``[B, S/2, d_inner]`` and
the RMSNorm kernel's call over d_inner is recorded at that shape, the SSD
kernel is called at ``[B, S/2, H, P]`` from the state of the rows before
(``init_state``), no more whole projection weights (or weight
gradients) are alive at once than one gather makes, and the block alone
saves neither
projection weight whole for its backward.  The numbers the sharded step
gives are held to the single process by ``tests/test_torch_parallel.py``.
"""
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_parallel_worker import FakeGroup  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import cost, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

KW = dict(dtype="bfloat16", head_dim=64)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "mamba2-370m"])
def test_mamba_products_and_conv_are_split(arch, monkeypatch):
    cfg = reduced_config(arch, ssm_expand=3, **KW)
    D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    proj, ch, k = 2 * di + 2 * N + H, di + 2 * N, cfg.ssm_conv
    made = []
    add = cost.CostMode._add

    def recorded(self, t):
        made.append((tuple(t.shape), t.dtype))
        return add(self, t)

    monkeypatch.setattr(cost.CostMode, "_add", recorded)
    with FakeGroup(8):
        mesh = make_debug_mesh(8, model=2)
        res = dryrun.run_cell(arch, "train_4k", False, verbose=False, mesh=mesh, cfg=cfg,
                              by_op=10**6)
    B, S = 256 // 4, 4096  # the cell's batch split over data 4
    outs = {o["op"].rsplit(" -> ", 1)[-1] for o in res["flops_by_op"] if " -> " in o["op"]}
    assert res["ok"] and outs
    assert str((D, proj)) not in outs and str((di, D)) not in outs, sorted(outs)
    # the blocks' own weight gradients: z's and x's [D, di/2], out_proj's [di/2, D]
    assert {str((D, di // 2)), str((di // 2, D))} <= outs, sorted(outs)
    assert not [m for m in made if len(m[0]) == 3 and m[0][-1] == proj], "a whole projection"
    assert (B, S + k - 1, ch) not in {m[0] for m in made}, "a whole conv input"
    assert (B, S + k - 1, di // 2) in {m[0] for m in made}  # the conv on each rank's channels


# the sp dry runs: jamba at one super-block
SP = {"jamba-1.5-large-398b": {"n_layers": 8}, "mamba2-370m": {}}


def _in_mamba() -> bool:
    """True while the Mamba block's own code is on the stack."""
    f = sys._getframe()
    while f is not None:
        if f.f_code.co_filename.endswith("models/mamba.py"):
            return True
        f = f.f_back
    return False


@pytest.fixture(scope="module")
def sp_runs():
    """Per arch of SP, its train_4k dry run under sp with every storage the
    step makes recorded (local shape, dtype, whether the Mamba block made
    it), each kernel call's local shapes, and the most storages of each
    whole projection-weight shape alive at once."""
    runs = {}
    for arch, overrides in SP.items():
        cfg = reduced_config(arch, ssm_expand=3, **overrides, **KW)
        D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        whole = {(D, 2 * di + 2 * N + H), (di, D)}
        rec = {"cfg": cfg, "made": [], "norms": [], "scans": [], "most_whole": dict.fromkeys(whole, 0)}
        live, alive = {}, dict.fromkeys(whole, 0)
        add, free = cost.CostMode._add, cost.CostMode._free

        def recorded(self, t):
            key, shape = cost._storage_key(t)[0], tuple(t.shape)
            if key not in self._live:
                rec["made"].append((shape, t.dtype, _in_mamba()))
                if shape in whole:
                    live[key] = shape
                    alive[shape] += 1
                    rec["most_whole"][shape] = max(rec["most_whole"][shape], alive[shape])
            return add(self, t)

        def freed(self, key):
            if key in live:
                alive[live.pop(key)] -= 1
            return free(self, key)

        def observe(name, inputs, outs, attrs):
            if name == "rmsnorm":
                rec["norms"].append(tuple(inputs["x"].shape))
            if name == "ssd_scan":
                rec["scans"].append((tuple(inputs["x"].shape), "init_state" in inputs))

        ops.META_OBSERVERS.append(observe)
        try:
            with pytest.MonkeyPatch.context() as mp, FakeGroup(8):
                mp.setattr(cost.CostMode, "_add", recorded)
                mp.setattr(cost.CostMode, "_free", freed)
                mesh = make_debug_mesh(8, model=2)
                rec["res"] = dryrun.run_cell(arch, "train_4k", False, verbose=False, mesh=mesh,
                                             cfg=cfg, opts=("sp",))
        finally:
            ops.META_OBSERVERS.remove(observe)
        runs[arch] = rec
    return runs


@pytest.mark.parametrize("arch, overrides", list(SP.items()))
def test_gated_norm_and_out_proj_on_sequence_rows_under_sp(arch, overrides, sp_runs):
    run = sp_runs[arch]
    di, res, norms = run["cfg"].d_inner, run["res"], run["norms"]
    B, S = 256 // 4, 4096  # the cell's batch split over data 4
    shapes = {m[0] for m in run["made"]}
    assert res["ok"] and (B, S, di) not in shapes, "a whole gated row"
    assert (B, S // 2, di) in shapes  # the gated rows, split on the sequence over model 2
    assert (B, S // 2, di) in norms and (B, S, di) not in norms, sorted(set(norms))


@pytest.mark.parametrize("arch", list(SP))
def test_mamba_block_on_sequence_rows_under_sp(arch, sp_runs):
    """The block makes no tensor whole on the sequence, launches the scan
    kernel on each rank's rows from the state carried from the rows
    before, and holds no more whole projection weights at once than one
    gather makes: each is gathered for its product and freed, not kept
    for the backward."""
    run = sp_runs[arch]
    cfg = run["cfg"]
    B, S, D, di = 256 // 4, 4096, cfg.d_model, cfg.d_inner
    assert run["res"]["ok"]
    by_block = {m[0] for m in run["made"] if m[2]}
    assert (B, S, D) not in by_block and (B, S, di) not in by_block, "a whole sequence"
    assert (B * S // 2, D) in by_block  # out_proj's product on the rows
    rows = (B, S // 2, cfg.ssm_heads, cfg.ssm_head_dim)
    n_mamba = cfg.n_scan_blocks * sum(m == "mamba" for m, _ in cfg.layer_kinds())
    # each layer's scan in the forward and in the remat recompute
    assert set(run["scans"]) == {(rows, True)}, sorted(set(run["scans"]))
    assert len(run["scans"]) == 2 * n_mamba, len(run["scans"])
    # one gather's storages: the all-gather's output and the tensor that
    # wraps it; a weight kept for the backward would add one a layer
    assert all(n <= 2 for n in run["most_whole"].values()), run["most_whole"]


@pytest.mark.parametrize("arch", list(SP))
def test_mamba_block_saves_no_whole_weight_under_sp(arch):
    """``apply_mamba`` alone on DTensors on the fake (4, 2) mesh under sp,
    without remat: no tensor it saves for the backward is a whole in_proj
    ``[D, Proj]`` or out_proj ``[d_inner, D]``, or whole on the sequence."""
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as M
    from repro_torch.parallel import opt_flags
    from repro_torch.parallel import sharding as sh

    cfg = reduced_config(arch, ssm_expand=3, **KW)
    D, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    saved = []

    def pack(t):
        saved.append(tuple((t.to_local() if isinstance(t, DTensor) else t).shape))
        return t

    with FakeGroup(8):
        mesh = make_debug_mesh(8, model=2)
        p = L.init_from_spec(torch.Generator(), M.mamba_spec(cfg), L.dtype_of(cfg), device="meta")
        p = sh.gather_fsdp(sh.distribute(p, {k: sh.to_placements(sh._param_spec((k,), v, cfg, mesh), mesh)
                                             for k, v in p.items()}, mesh))
        x = sh.distribute(torch.empty(16, 64, D, device="meta", dtype=torch.bfloat16),
                          sh.to_placements(("data", "model", None), mesh), mesh).requires_grad_()
        opt_flags.set_flags(sp=True, batch_axes="data")
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                y = M.apply_mamba(p, cfg, x)
        finally:
            opt_flags.reset()
    assert tuple(y.to_local().shape) == (4, 32, D)
    assert saved and not {(D, 2 * di + 2 * N + H), (di, D)} & set(saved), sorted(set(saved))
    assert not [s for s in saved if len(s) >= 3 and s[:2] == (4, 64)], "a tensor whole on the sequence"
