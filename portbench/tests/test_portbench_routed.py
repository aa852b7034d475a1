"""The ``serve_waves_routed`` kind, its cell and its two per-layer metrics:
the manifest validates with the cell; at a test size on the CPU a sound run
is correct, a traced one reports what the CPU can read, a broken timed path,
the control and the calibration's faults are not correct; a program
without the routing read-out fails before any weight is drawn; and the
metrics' readers on synthetic spans."""
import json
import shutil
import time
from types import SimpleNamespace

import pytest
import torch

from portbench.bench import Bench, Reading, Run, run_cell

from .conftest import ROOT, TINY, make_tiny_root
from .test_portbench_faults import SERVE_FAULTS

CELL = "qwen3-moe-30b-a3b.serve_longdoc"
TINY_CELL = "tiny-moe.tiny_serve_routed"
SEED = 2_147_483_659
NEW_METRICS = {"moe_host_ms.serve", "expert_roofline.serve"}
APPENDED = {"serve_tokens_per_s", "decode_call_ms.serve", "prefill_call_p80_ms.serve", "mfu.serve",
            "device_idle.serve", "idle_in_launch.serve", "flash_decode_roofline.serve"}


@pytest.fixture(scope="module")
def routed_root(tmp_path_factory):
    """The tiny benchmark with the test size of this cell beside the real
    one, added as a later change adds a cell: files and manifest entries."""
    torch.set_num_threads(2)
    dest = make_tiny_root(tmp_path_factory.mktemp("routed"))
    shutil.copy(TINY / "tiny_serve_routed.json", dest / "portbench" / "workloads" / "tiny_serve_routed.json")
    shutil.copy(TINY / "limits" / f"{TINY_CELL}.json", dest / "portbench" / "limits" / f"{TINY_CELL}.json")
    man = json.loads((dest / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": TINY_CELL, "config": "tiny-moe", "traffic": "tiny_serve_routed", "chips": 1,
                             "why": "test size"})
    for m in man["end_to_end"] + man["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(TINY_CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return dest


def run(root, trace=False, seed=SEED):
    b = Bench(root)
    c = b.cell(TINY_CELL)
    return run_cell(Run(b, c, b.config(c), b.mix(c), seed, 0.3, trace, "cpu", time.perf_counter()))


def test_the_benchmark_validates_with_the_cell():
    b = Bench(ROOT)
    assert b.validate() == []
    cell = b.cell(CELL)
    assert cell["chips"] == 1 and b.mix(cell)["kind"] == "serve_waves_routed" and b.config(cell)["reduced"] == []
    assert {m["name"] for m in b.end_to_end(CELL)} == {"setup_s", "serve_tokens_per_s"}
    assert {m["name"] for m in b.per_layer(CELL)} == (APPENDED | NEW_METRICS) - {"serve_tokens_per_s"}
    assert set(b.limits(cell)) == {"logit_gap", "logit_gap_mean", "route_margin", "keep_mismatch"}
    assert b.limits(cell)["keep_mismatch"]["limit"] == 0


def test_the_configuration_is_the_ports_model_at_its_published_widths():
    from portbench import program

    b = Bench(ROOT)
    cfg = b.config(b.cell(CELL))
    arch = program.arch(cfg)
    assert (arch.n_layers, arch.d_model, arch.n_experts, arch.top_k, arch.d_ff) == (48, 2048, 128, 8, 768)
    assert arch.padded_vocab == cfg["padded_vocab_size"] == 152064


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(routed_root, trace):
    line = run(routed_root, trace)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0, line
    assert list(line["compared"]) == ["logit_gap", "logit_gap_mean", "route_margin", "keep_mismatch"]
    if trace:
        # on the CPU no device operation is traced and no span has device stamps
        assert set(line["metrics"]) == {"decode_call_ms.serve", "mfu.serve", "moe_host_ms.serve"}
    else:
        assert set(line["metrics"]) == {"setup_s", "serve_tokens_per_s"}


def _route_swapped(monkeypatch, vocab):
    """The first layer of each call takes each token's K+1-th expert for
    its K-th."""
    from repro_torch.models import moe

    scores, n = moe._scores, [0]

    def swapped(router, cfg, xt):
        probs, top_p, top_i = scores(router, cfg, xt)
        n[0] += 1
        if n[0] % cfg.n_layers == 1:
            top_i = torch.cat([top_i[:, :-1], torch.topk(probs, cfg.top_k + 1, dim=-1).indices[:, -1:]], 1)
        return probs, top_p, top_i

    monkeypatch.setattr(moe, "_scores", swapped)


def _capacity_one_slot_short(monkeypatch, vocab):
    from repro_torch.models import moe

    capacity = moe.moe_capacity
    monkeypatch.setattr(moe, "moe_capacity", lambda cfg, n: capacity(cfg, n) - 1)


@pytest.mark.parametrize("fault", SERVE_FAULTS + [_route_swapped, _capacity_one_slot_short],
                         ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(routed_root, monkeypatch, fault):
    fault(monkeypatch, 512)
    line = run(routed_root)
    assert not line["correct"], line["compared"]


def test_the_control_and_the_faults_fail_a_limit(routed_root):
    from portbench import calibrate_routed

    b = Bench(routed_root)
    c = b.cell(TINY_CELL)
    cfg, mix, limits = b.config(c), b.mix(c), b.limits(c)
    kind = b.kind(mix)
    out = kind.run(Run(b, c, cfg, mix, SEED, 0.3, False, "cpu", time.perf_counter()))
    got = calibrate_routed.faults(kind, cfg, mix, out, SEED, "cpu")
    assert set(got) == {"control", "token", "route", "control_detail"}
    for name in calibrate_routed.FAULTS:
        assert any(got[name][k] > lim["limit"] for k, lim in limits.items()), (name, got[name])
    assert got["route"]["route_margin"] > limits["route_margin"]["limit"]


def test_a_program_without_the_routing_read_out_fails_before_drawing_weights(routed_root, monkeypatch):
    from portbench import weights
    from repro_torch.models import moe

    monkeypatch.delattr(moe, "record_routing")
    monkeypatch.setattr(weights, "draw", lambda *a: pytest.fail("weights drawn"))
    with pytest.raises(RuntimeError, match="record_routing"):
        run(routed_root)


# --------------------------------------------------------------------------
# the two metrics' readers, on synthetic spans
# --------------------------------------------------------------------------


def span(id, name, start_us, end_us, parent=None, device_ms=None, **attrs):
    return SimpleNamespace(id=id, name=name, parent=parent, start=int(start_us * 1000), end=int(end_us * 1000),
                           attrs=attrs, device_ms=lambda: device_ms)


def decode_steps():
    """Two decode steps of one layer each, and a prefill's layer outside
    them; the first step's layer counted with device tensors."""
    t = torch.tensor
    return [span(0, "serve.decode", 0, 1000), span(1, "moe.route", 100, 400, pairs=16, kept=t(12), live=t(5),
                                                    max_load=t(4)),
            span(2, "moe.experts", 150, 300, 1, device_ms=0.5),
            span(3, "serve.decode", 2000, 3000), span(4, "moe.route", 2100, 2300, pairs=16, kept=16, live=8,
                                                       max_load=3),
            span(5, "moe.experts", 2150, 2200, 4, device_ms=0.25),
            span(6, "moe.route", 5000, 9000, pairs=800, kept=400, live=8, max_load=200),
            span(7, "moe.experts", 5100, 8000, 6, device_ms=9.0)]


def test_moe_host_ms_is_the_median_step_of_the_layers_host_time(monkeypatch):
    import repro_torch.spans

    monkeypatch.setattr(repro_torch.spans, "session", decode_steps)
    reader = Bench(ROOT).reader("moe_host_ms.serve")
    assert reader(Reading({}, {}, {}, SimpleNamespace())) == pytest.approx((0.3 + 0.2) / 2)
    assert reader(Reading({}, {}, {}, None)) is None
    monkeypatch.setattr(repro_torch.spans, "session", lambda: decode_steps()[:1])
    assert reader(Reading({}, {}, {}, SimpleNamespace())) is None


def test_expert_roofline_counts_the_live_experts_and_kept_pairs(monkeypatch):
    import repro_torch.spans
    from portbench import yardstick as Y

    cfg = {"hidden_size": 2048, "moe_intermediate_size": 768}
    monkeypatch.setattr(repro_torch.spans, "session", decode_steps)
    reader = Bench(ROOT).reader("expert_roofline.serve")
    D, F = 2048, 768
    least = (Y.least_ms(5 * 3 * D * F * 2 + 2 * 12 * D * 2, 6 * D * F * 12)
             + Y.least_ms(8 * 3 * D * F * 2 + 2 * 16 * D * 2, 6 * D * F * 16))
    assert reader(Reading(cfg, {}, {}, SimpleNamespace())) == pytest.approx(100 * least / 0.75)
    no_stamps = [s if s.name != "moe.experts" else span(s.id, s.name, 0, 1, s.parent) for s in decode_steps()]
    monkeypatch.setattr(repro_torch.spans, "session", lambda: no_stamps)
    assert reader(Reading(cfg, {}, {}, SimpleNamespace())) is None


def test_the_metrics_read_nothing_from_a_program_without_spans(monkeypatch):
    """The two new readers, and the per-layer metrics this cell was added
    to, read None where the program has no spans module."""
    import sys

    b = Bench(ROOT)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)  # its import now fails
    r = Reading({"hidden_size": 2048, "moe_intermediate_size": 768, "num_attention_heads": 32,
                 "num_key_value_heads": 4, "head_dim": 128, "num_hidden_layers": 48},
                {"max_len": 4096}, {"traced_s": 1.0}, SimpleNamespace(device=[], kernels=lambda n: []))
    for name in sorted(NEW_METRICS | {"idle_in_launch.serve", "flash_decode_roofline.serve"}):
        assert b.reader(name)(r) is None, name
