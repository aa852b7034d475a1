"""The manifest and the files it names: names and units, every file found
by name, and a later change's files found without an edit."""
import json
import shutil

import pytest

from portbench.bench import NAME, UNIT, Bench

from .conftest import ROOT

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_the_repository_benchmark_validates():
    assert Bench(ROOT).validate() == []


def test_manifest_keys_names_and_units():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(man) == TOP_KEYS
    assert man["command"] == ["python3", "portbench/run.py"] and man["paths"] == ["portbench"]
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("portbench/configs/")
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    assert {m["name"] for m in man["end_to_end"]} == {"setup_s", "serve_tokens_per_s", "train_tokens_per_s"}


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    b = Bench(ROOT)
    w = b.cell(cell)
    cfg, mix = b.config(w), b.mix(w)
    assert cfg["name"] == w["config"] and callable(b.kind(mix).run)
    assert b.limits(w) and len(b.end_to_end(cell)) == 2 and b.per_layer(cell)
    for m in b.per_layer(cell):
        assert m["moves"] in {e["name"] for e in b.end_to_end(cell)} and callable(b.reader(m["name"]))


METRIC = '''"""The share of the window's decode calls above 40 ms, in %."""


def read(r):
    calls = r.records.get("decode_s")
    return 100.0 * sum(c > 0.04 for c in calls) / len(calls) if calls else None
'''


def test_a_later_change_adds_a_mix_and_a_metric_as_files(tmp_path):
    """A copy of the benchmark takes a new mix, cell and metric as new files
    and manifest entries; the harness finds and validates both, and reports
    a metric whose reader is missing."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "portbench" / "workloads" / "serve_longdoc.json").read_text())
    mix["prompt"] = {"median": 256, "sigma": 0.8, "min": 32, "max": 1024}
    (tmp_path / "portbench" / "workloads" / "serve_chat.json").write_text(json.dumps(mix))
    (tmp_path / "portbench" / "metrics" / "slow_decode_share.serve.py").write_text(METRIC)
    shutil.copy(ROOT / "portbench" / "limits" / "deepseek-7b.serve_longdoc.json",
                tmp_path / "portbench" / "limits" / "deepseek-7b.serve_chat.json")
    cell = "deepseek-7b.serve_chat"
    man["workloads"].append({"name": cell, "config": "deepseek-7b", "traffic": "serve_chat", "chips": 1,
                             "why": "short chat"})
    man["end_to_end"][0]["workloads"].append(cell)
    man["per_layer"].append({"name": "slow_decode_share.serve", "unit": "%", "better": "lower",
                             "source": "program_span", "layer": "engine", "moves": "serve_tokens_per_s",
                             "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    b = Bench(tmp_path)
    assert b.validate() == []
    assert b.mix(b.cell(cell))["prompt"]["median"] == 256
    assert [m["name"] for m in b.per_layer(cell)] == ["slow_decode_share.serve"]
    reading = type("R", (), {"records": {"decode_s": [0.03, 0.05]}})
    assert b.reader("slow_decode_share.serve")(reading) == 50.0
    (tmp_path / "portbench" / "metrics" / "slow_decode_share.serve.py").unlink()
    assert any("slow_decode_share.serve" in p for p in Bench(tmp_path).validate())


@pytest.mark.parametrize("workloads, want", [
    (None, "x.train lists no workloads"),
    ([], "x.train lists no workloads"),
    (["deepseek-7b.serve_longdoc"], "x.train: deepseek-7b.serve_longdoc does not report train_tokens_per_s"),
])
def test_a_metric_names_its_cells_and_each_reports_what_it_moves(workloads, want):
    b = Bench(ROOT)
    metric = {"name": "x.train", "unit": "%", "better": "lower", "source": "device_trace", "layer": "device",
              "moves": "train_tokens_per_s"}
    if workloads is not None:
        metric["workloads"] = workloads
    b.manifest["per_layer"].append(metric)
    assert want in b.validate()
    for w in b.manifest["workloads"]:  # a metric goes to the cells it lists, and to no other
        assert ("x.train" in [m["name"] for m in b.per_layer(w["name"])]) == (w["name"] in (workloads or []))
