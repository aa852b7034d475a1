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
Under ``sp`` (one dry run per arch, jamba cut to one super-block), the
gated norm and out_proj run on each rank's sequence rows
(``_gate_and_project_rows``), as the reference's partitioner runs them:
no ``[B, S, d_inner]`` tensor is made, the gated rows are ``[B, S/2,
d_inner]``, and the RMSNorm kernel's call over d_inner is recorded at that
shape.  The numbers the sharded step gives are held to the single process
by ``tests/test_torch_parallel.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_parallel_worker import FakeGroup  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import cost, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402

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


@pytest.mark.parametrize("arch, overrides", [("jamba-1.5-large-398b", {"n_layers": 8}),
                                             ("mamba2-370m", {})])
def test_gated_norm_and_out_proj_on_sequence_rows_under_sp(arch, overrides, monkeypatch):
    cfg = reduced_config(arch, ssm_expand=3, **overrides, **KW)
    di = cfg.d_inner
    made, norms = [], []
    add = cost.CostMode._add

    def recorded(self, t):
        made.append((tuple(t.shape), t.dtype))
        return add(self, t)

    def observe(name, inputs, outs, attrs):
        if name == "rmsnorm":
            norms.append(tuple(inputs["x"].shape))

    monkeypatch.setattr(cost.CostMode, "_add", recorded)
    ops.META_OBSERVERS.append(observe)
    try:
        with FakeGroup(8):
            mesh = make_debug_mesh(8, model=2)
            res = dryrun.run_cell(arch, "train_4k", False, verbose=False, mesh=mesh, cfg=cfg,
                                  opts=("sp",))
    finally:
        ops.META_OBSERVERS.remove(observe)
    B, S = 256 // 4, 4096  # the cell's batch split over data 4
    shapes = {m[0] for m in made}
    assert res["ok"] and (B, S, di) not in shapes, "a whole gated row"
    assert (B, S // 2, di) in shapes  # the gated rows, split on the sequence over model 2
    assert (B, S // 2, di) in norms and (B, S, di) not in norms, sorted(set(norms))
