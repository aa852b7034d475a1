"""The join of the program's spans to a trace (``hostspans``) and the
readers of the span metrics, on synthetic spans and a synthetic trace; then
a traced run at a test size on the CPU."""
import json
import sys
import time
from types import SimpleNamespace

import pytest

from portbench import hostspans
from portbench import yardstick as Y
from portbench.bench import Bench, Reading, Run, run_cell

from .conftest import ROOT

SHIFT_US = 5000.0  # the trace's clock runs this far behind the spans'
SERVE_METRICS = ["idle_in_launch.serve", "idle_in_sample.serve", "idle_in_admit.serve",
                 "idle_unspanned.serve", "queue_wait_ms.serve", "flash_decode_roofline.serve"]
TRAIN_METRICS = ["forward_device_ms.train", "backward_device_ms.train", "adamw_device_ms.train"]


def span(id, name, start_us, end_us, parent=None, device_ms=None, **attrs):
    return SimpleNamespace(id=id, name=name, parent=parent, start=int(start_us * 1000),
                           end=None if end_us is None else int(end_us * 1000), attrs=attrs,
                           device_ms=lambda: device_ms)


def wave():
    """One request: its prefill, row scatter, a sample, a decode step and the
    last sample, in µs on the host's clock."""
    return [span(0, "serve.request", 0, 1000, request_id=7),
            span(1, "serve.prefill", 10, 400, request_id=7, prompt_len=5),
            span(2, "serve.cache_init", 10, 50, 1), span(3, "serve.forward", 50, 300, 1),
            span(4, "serve.readback", 300, 400, 1),
            span(5, "serve.insert_row", 400, 420, request_id=7),
            span(6, "serve.sample", 420, 500, rows=1),
            span(7, "serve.decode", 500, 900, rows=2, keys=1000),
            span(8, "serve.forward", 500, 700, 7), span(9, "serve.readback", 700, 900, 7),
            span(10, "serve.sample", 900, 990, rows=1)]


def device(host_ops):
    """A trace of operations given on the host's clock."""
    return Y.Trace([(n, a - SHIFT_US, b - SHIFT_US) for n, a, b in host_ops])


OPS = [("memset", 20, 40), ("k1", 100, 250), ("Memcpy DtoH (Device -> Pageable)", 310, 395),
       ("copy", 405, 415), ("flash_decode_kernel", 550, 650), ("Memcpy DtoH (Device -> Pageable)", 720, 900)]
WINDOW_S = 1100e-6  # the spans' 1000 µs and 100 µs of the harness around them


def test_the_fitted_offset_recovers_a_known_shift():
    # the second copy ends with its read-back span, the first 5 µs before
    ends = [395 - SHIFT_US, 900 - SHIFT_US]
    assert hostspans.offsets_us(wave(), device(OPS)) == [(e, pytest.approx(SHIFT_US)) for e in ends]


def test_the_offset_follows_a_step_of_the_clock():
    """The device's clock steps 1 ms behind the host's between the two
    read-backs: each segment gets its own offset, its copy's end at its
    read-back's end (the first 5 µs later than the truth), where one offset
    for the window would put the second segment 1 ms early."""
    late = [(n, a, b) if b <= 395 else (n, a + 1000, b + 1000) for n, a, b in OPS]
    offs = hostspans.offsets_us(wave(), device(late))
    assert [o for _, o in offs] == [pytest.approx(SHIFT_US + 5), pytest.approx(SHIFT_US - 1000)]
    want = [(n, a + 5, b + 5) if b <= 395 else (n, a, b) for n, a, b in OPS]
    assert hostspans.on_host(wave(), device(late)) == pytest.approx(want, abs=1e-6)
    split = hostspans.idle_us(wave(), device(late), WINDOW_S)
    # gaps [0,25] [45,105] [255,315] [400,405] [415,550] [650,720] [900,1000]
    assert split == pytest.approx({"admit": 15 + 5 + 5 + 5, "launch": 55 + 45 + 50 + 50,
                                   "sample": 15 + 80 + 20 + 90, "unspanned": 10 + 10 + 100})


@pytest.mark.parametrize("ops", [
    OPS + [("Memcpy DtoH (Device -> Pageable)", 950, 960)],  # a copy no read-back waits for
    OPS[:2] + OPS[3:],  # a read-back without its copy
    OPS + [("k2", 1040, 1060)],  # an operation after the spans' extent
])
def test_the_join_refuses_what_does_not_pair(ops):
    assert hostspans.on_host(wave(), device(ops)) is None
    assert hostspans.idle_us(wave(), device(ops), WINDOW_S) is None


def test_the_idle_time_is_split_by_the_leaf_span_open():
    # gaps [0,20] [40,100] [250,310] [395,405] [415,550] [650,720] [900,1000],
    # and 100 µs of the window outside the spans
    split = hostspans.idle_us(wave(), device(OPS), WINDOW_S)
    assert split == pytest.approx({"admit": 10 + 10 + 5 + 5, "launch": 50 + 50 + 50 + 50,
                                   "sample": 10 + 5 + 80 + 20 + 90, "unspanned": 10 + 10 + 100})


def test_the_four_idle_shares_sum_to_the_idle_share(monkeypatch):
    import repro_torch.spans

    monkeypatch.setattr(repro_torch.spans, "session", wave)
    b = Bench(ROOT)
    trace = device(OPS + [("k3", 990, 1030)])  # partly past the spans' end, within the slack
    r = Reading({}, {}, {"traced_s": WINDOW_S}, trace)
    shares = [b.reader(f"idle_{k}.serve")(r) for k in ("in_launch", "in_sample", "in_admit", "unspanned")]
    assert sum(shares) == pytest.approx(Y.idle_share(trace, WINDOW_S), abs=1e-9)
    assert shares[0] == pytest.approx(100 * 200 / 1100)


def test_the_queue_wait_is_the_median_from_arrival_to_prefill(monkeypatch):
    import repro_torch.spans

    spans = [span(0, "serve.request", 0, 900, request_id=1), span(1, "serve.request", 0, 900, request_id=2),
             span(2, "serve.request", 0, 900, request_id=3),
             span(3, "serve.prefill", 10, 100, request_id=1), span(4, "serve.prefill", 100, 400, request_id=2),
             span(5, "serve.prefill", 400, 450, request_id=3)]
    monkeypatch.setattr(repro_torch.spans, "session", lambda: spans)
    assert Bench(ROOT).reader("queue_wait_ms.serve")(Reading({}, {}, {}, None)) == pytest.approx(0.1)


def test_the_decode_roofline_needs_one_launch_a_layer_and_step(monkeypatch):
    import repro_torch.spans

    cfg = json.loads((ROOT / "portbench" / "configs" / "deepseek-7b.json").read_text())
    monkeypatch.setattr(repro_torch.spans, "session", wave)
    read = Bench(ROOT).reader("flash_decode_roofline.serve")
    # 1000 keys of 32 heads of 128 in K and V, q and out of 2 rows, 4096 + 2 int32 positions
    moved = 2 * 1000 * 32 * 128 * 2 + 2 * 2 * 32 * 128 * 2 + 4 * 4096 + 4 * 2
    least = moved / 3.35e12 * 1e3
    launches = [("flash_decode_kernel<bf16>", 10.0 * i, 10.0 * i + 8.0) for i in range(30)]
    r = Reading(cfg, {"max_len": 4096}, {}, Y.Trace(launches))
    assert read(r) == pytest.approx(100 * 30 * least / (30 * 8e-3))
    assert read(Reading(cfg, {"max_len": 4096}, {}, Y.Trace(launches[:29]))) is None


def test_the_step_phases_are_medians_of_per_step_sums():
    spans = [span(0, "train.step", 0, 10), span(1, "train.forward", 0, 1, 0, 2.0),
             span(2, "train.forward", 1, 2, 0, 3.0), span(3, "train.adamw", 2, 3, 0, 1.0),
             span(4, "train.step", 10, 20), span(5, "train.forward", 10, 11, 4, 4.0),
             span(6, "train.adamw", 11, 12, 4, 1.5),
             span(7, "train.step", 20, 30), span(8, "train.forward", 20, 21, 7, 7.0),
             span(9, "train.adamw", 21, 22, 7, 2.5),
             span(10, "train.step", 30, None), span(11, "train.forward", 30, 31, 10, 9.0)]  # cut off
    assert hostspans.step_device_ms(spans, "train.forward") == 5.0  # steps of 5, 4 and 7
    assert hostspans.step_device_ms(spans, "train.adamw") == 1.5
    assert hostspans.step_device_ms(spans, "train.backward") is None
    host_only = [span(0, "train.step", 0, 10), span(1, "train.adamw", 0, 1, 0, None)]
    assert hostspans.step_device_ms(host_only, "train.adamw") is None


def test_the_nine_metrics_read_nothing_from_a_program_without_spans(monkeypatch):
    b = Bench(ROOT)
    assert b.validate() == []
    listed = {m["name"]: m for m in b.manifest["per_layer"]}
    for name in SERVE_METRICS + TRAIN_METRICS:
        assert listed[name]["workloads"] == ["deepseek-7b.serve_longdoc" if name.endswith(".serve")
                                             else "deepseek-7b.train_8k"]
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)  # its import now fails
    r = Reading({}, {"max_len": 4096}, {"traced_s": WINDOW_S}, device(OPS))
    assert [b.reader(n)(r) for n in SERVE_METRICS + TRAIN_METRICS] == [None] * 9


def test_a_traced_serve_run_reports_the_queue_wait(tiny_root):
    b = Bench(tiny_root)
    c = b.cell("tiny-dense.tiny_serve")
    line = run_cell(Run(b, c, b.config(c), b.mix(c), 2_147_483_659, 0.3, True, "cpu", time.perf_counter()))
    assert line["correct"]
    # on the CPU the trace holds no device operation: what the join needs is left out
    assert "queue_wait_ms.serve" in line["metrics"] and line["metrics"]["queue_wait_ms.serve"]["value"] >= 0
    assert not set(line["metrics"]) & (set(SERVE_METRICS) - {"queue_wait_ms.serve"})
