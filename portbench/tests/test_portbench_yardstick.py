"""The yardstick's arithmetic against numbers worked by hand, and the
reduction of a trace."""
import json

import pytest

from portbench import yardstick as Y

from .conftest import ROOT


def cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


PAIRS_4096 = 4096 * 4097 // 2  # 8,390,656 causal (query, key) pairs
# Qwen3-30B-A3B's published sizes (hf Qwen/Qwen3-30B-A3B), 4 of its 48 layers
QWEN3_MOE_4_LAYERS = {"num_hidden_layers": 4, "hidden_size": 2048, "num_attention_heads": 32,
                      "num_key_value_heads": 4, "head_dim": 128, "num_experts": 128, "num_experts_per_tok": 8,
                      "moe_intermediate_size": 768, "vocab_size": 151936}


def test_train_step_flops_of_deepseek_7b_8_layers():
    dense = 8 * (4 * 4096 * 4096 + 3 * 4096 * 11008) + 4096 * 102400  # 2,038,431,744
    attn = 8 * 2 * PAIRS_4096 * 4 * 32 * 128  # QK^T and PV, forward
    assert dense == 2_038_431_744
    want = 6 * dense * 8192 + 3 * attn
    assert Y.train_step_flops(cfg("deepseek-7b-8of30"), 2, 4096) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(1.0679e14, rel=1e-4)


def test_train_step_flops_of_qwen3_moe_4_layers():
    attn_w = 2048 * 4096 + 2 * 2048 * 512 + 4096 * 2048
    ff_w = 2048 * 128 + 8 * 3 * 2048 * 768  # the router and the 8 experts a token meets
    dense = 4 * (attn_w + ff_w) + 2048 * 151936
    assert dense == 538_705_920
    want = 6 * dense * 8192 + 3 * 4 * 2 * PAIRS_4096 * 4 * 32 * 128
    assert Y.train_step_flops(QWEN3_MOE_4_LAYERS, 2, 4096) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(2.9778e13, rel=1e-4)


def test_serve_request_flops():
    c = cfg("deepseek-7b")
    per_layer = 4 * 4096 * 4096 + 3 * 4096 * 11008
    # 100 prompt tokens and 3 generated: 102 tokens through the layers, 3 rows of logits,
    # 5050 prompt pairs and 101 + 102 pairs of the two fed generated tokens
    want = 2 * 30 * per_layer * 102 + 2 * 4096 * 102400 * 3 + 30 * 4 * 32 * 128 * (5050 + 101 + 102)
    assert Y.serve_request_flops(c, 100, 3) == pytest.approx(want, rel=1e-12)


def test_flash_and_rmsnorm_least_times_at_the_cells_shapes():
    # deepseek-7b train step: B=2 S=4096 H=G=32 K=128, operations bound
    flops = 4 * 128 * 32 * 2 * PAIRS_4096
    assert Y.flash_causal_least_ms(2, 4096, 32, 32, 128) == pytest.approx(flops / 989e12 * 1e3, rel=1e-12)
    assert Y.flash_causal_least_ms(2, 4096, 32, 32, 128) == pytest.approx(0.27799, rel=1e-4)
    # qwen3-moe: G=4, still operations bound
    assert Y.flash_causal_least_ms(2, 4096, 32, 4, 128) == pytest.approx(0.27799, rel=1e-4)
    # a short prefill is bytes bound: q, out, k, v of 16 positions and the positions
    moved = 4 * 16 * 32 * 128 * 2 + 4 * 2 * 16
    assert Y.flash_causal_least_ms(1, 16, 32, 32, 128) == pytest.approx(moved / 3.35e12 * 1e3, rel=1e-12)
    # RMSNorm over a step's 8192 x 4096 rows: x read and y written, bytes bound
    assert Y.rmsnorm_least_ms(8192, 4096) == pytest.approx((8192 * 4096 * 4 + 4 * 4096) / 3.35e12 * 1e3)
    assert Y.rmsnorm_least_ms(8192, 4096) == pytest.approx(0.040070, rel=1e-4)
    assert Y.rmsnorm_least_ms(8192 * 32, 128) == pytest.approx((8192 * 32 * 128 * 4 + 512) / 3.35e12 * 1e3)


def trace():
    return Y.Trace([("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 100.0, 110.0), ("k2", 300.0, 305.0)])


def test_busy_time_is_the_union_of_device_intervals():
    t = trace()
    assert t.busy_intervals() == [(0.0, 20.0), (100.0, 110.0), (300.0, 305.0)]
    assert t.busy_seconds() == pytest.approx(35e-6)
    assert t.top_device_ops() == [["k1", pytest.approx(20e-6)], ["k2", pytest.approx(20e-6)]]
    assert Y.idle_share(t, 1e-3) == pytest.approx(96.5)
    assert Y.idle_share(None, 1.0) is None


def test_idle_gaps_by_the_operation_that_ends_them():
    assert trace().idle_gaps() == [["before k2", pytest.approx(190e-6)], ["before k1", pytest.approx(80e-6)]]
    assert trace().idle_gaps(at_least_us=100.0) == [["before k2", pytest.approx(190e-6)]]


def test_a_roofline_share_needs_one_launch_a_call():
    t = trace()
    assert Y.roofline_share([0.005, 0.005], t.kernels("k1")) == pytest.approx(50.0)
    assert Y.roofline_share([0.005], t.kernels("k1")) is None
    assert Y.roofline_share([0.005], t.kernels("nothing")) is None


def test_a_trace_file_is_reduced_to_the_devices_operations(tmp_path):
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 1.0, "dur": 2.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.5, "dur": 1.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 4.0, "dur": 1.0},
              {"ph": "i", "cat": "kernel", "name": "marker", "ts": 0.0}]
    (tmp_path / "t.json").write_text(json.dumps({"traceEvents": events}))
    assert Y.Trace.load(str(tmp_path / "t.json")).device == [("k", 1.0, 3.0), ("Memcpy DtoH", 4.0, 5.0)]
