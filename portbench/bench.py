"""The harness.  It finds everything of a cell by the names in
``BENCHMARK.json``: the configuration by its ``file``, the traffic mix as
``workloads/<traffic>.json``, the mix's traffic kind as
``traffic/<kind>.py``, the limits of the comparison as
``limits/<cell>.json`` and each per-layer metric's reader as
``metrics/<metric>.py``.  So a later change adds a configuration, a mix, a
kind or a metric by adding files, and edits none.

A traffic kind's ``run(run)`` builds the program, warms it up, measures the
window, reads the device's peak memory, frees the program and runs the
reference; it returns what happened (``Outcome``).  A metric reader's
``read(reading)`` takes a number from the records and the trace of a
``--trace 1`` run, or returns None where it finds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _load(path: Path) -> ModuleType:
    """A module from a file whose name may hold dots (``mfu.train.py``)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    name = "portbench_" + re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")

    def mix(self, cell: dict) -> dict:
        return json.loads((self.dir / "workloads" / f"{cell['traffic']}.json").read_text())

    def kind(self, mix: dict) -> ModuleType:
        return _load(self.dir / "traffic" / f"{mix['kind']}.py")

    def limits(self, cell: dict) -> dict:
        return json.loads((self.dir / "limits" / f"{cell['name']}.json").read_text())

    def reader(self, metric: str) -> Callable:
        return _load(self.dir / "metrics" / f"{metric}.py").read

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.manifest["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics that list the cell."""
        return [m for m in self.manifest["per_layer"] if cell in m.get("workloads", [])]

    def validate(self) -> List[str]:
        """What is wrong with the manifest and the files it names; empty
        when every name, unit and file holds."""
        bad: List[str] = []
        man = self.manifest
        metrics = man.get("end_to_end", []) + man.get("per_layer", [])
        names = [c["name"] for c in man.get("configs", [])] + [w["name"] for w in man.get("workloads", [])]
        names += [m["name"] for m in metrics]
        for n in names + [w.get("traffic", "") for w in man.get("workloads", [])]:
            if not NAME.match(n):
                bad.append(f"name {n!r}")
        for m in metrics:
            if not UNIT.match(m.get("unit", "")):
                bad.append(f"unit of {m['name']}: {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher") or m.get("source") not in SOURCES:
                bad.append(f"better or source of {m['name']}")
        if "setup_s" not in {m["name"] for m in man.get("end_to_end", [])}:
            bad.append("no setup_s")
        for c in man.get("configs", []):
            if not (self.root / c["file"]).is_file():
                bad.append(f"configuration file {c['file']}")
        for w in man.get("workloads", []):
            try:
                self.config(w)
                mix = self.mix(w)
                if not callable(getattr(self.kind(mix), "run", None)):
                    bad.append(f"traffic kind {mix['kind']} has no run()")
                self.limits(w)
            except (OSError, KeyError, ValueError) as e:
                bad.append(f"workload {w['name']}: {type(e).__name__} {e}")
            if not self.per_layer(w["name"]):
                bad.append(f"workload {w['name']} has no per-layer metric")
            if len(self.end_to_end(w["name"])) < 2:
                bad.append(f"workload {w['name']} reports no end-to-end metric but setup_s")
        e2e = {m["name"] for m in man.get("end_to_end", [])}
        for m in man.get("per_layer", []):
            if m.get("moves") not in e2e:
                bad.append(f"{m['name']} moves no end-to-end metric")
            if not m.get("workloads"):
                bad.append(f"{m['name']} lists no workloads")
            for c in m.get("workloads", []):
                if m.get("moves") not in {e["name"] for e in self.end_to_end(c)}:
                    bad.append(f"{m['name']}: {c} does not report {m.get('moves')}")
            try:
                self.reader(m["name"])
            except (OSError, AttributeError) as e:
                bad.append(f"metric {m['name']}: {type(e).__name__} {e}")
        return bad


@dataclass
class Run:
    """One run of a cell, as a traffic kind sees it."""

    bench: Bench
    cell: dict
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float  # host clock at process start

    def log(self, *args) -> None:
        print(f"[{time.perf_counter() - self.t0:8.2f} s]", *args, file=sys.stderr, flush=True)


@dataclass
class Outcome:
    attempted: int
    failed: int
    e2e: Dict[str, float]  # the end-to-end metrics, by name
    compared: Dict[str, float]  # the numbers the cell's limits may hold, by name
    memory_peak_bytes: int = 0
    records: Dict = field(default_factory=dict)  # what the per-layer readers read
    trace: Optional[object] = None  # yardstick.Trace of the traced sub-window
    traced_s: float = 0.0  # its length on the host's clock


@dataclass
class Reading:
    """What a per-layer metric's reader gets."""

    cfg: dict
    mix: dict
    records: Dict
    trace: Optional[object]


def profiled(fn: Callable[[], object], cuda: bool):
    """``fn()`` under ``torch.profiler``: (its result, the reduced trace,
    the seconds it took on the host's clock to a synchronised end).  On the
    card the device's activity alone is traced: tracing the host's
    operations too slows a host-paced wave by half, and the device then
    reads idle for longer than it is.  The Chrome trace is written to the
    temporary directory and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .yardstick import Trace

    if cuda:
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        out = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = Trace.load(path)
    finally:
        os.remove(path)
    print(f"trace: {len(trace.device)} device operations, stopped and read in "
          f"{time.perf_counter() - t0 - wall:.3f} s", file=sys.stderr)
    return out, trace, wall


def run_cell(run: Run) -> dict:
    """Run the cell and return the result line's object."""
    bench = run.bench
    name = run.cell["name"]
    limits = bench.limits(run.cell)
    out: Outcome = bench.kind(run.mix).run(run)
    run.log("read:", json.dumps(out.compared))
    if run.trace:
        reading = Reading(run.cfg, run.mix, out.records, out.trace)
        metrics = {}
        for m in bench.per_layer(name):
            value = bench.reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]], "unit": m["unit"]}
                   for m in bench.end_to_end(name)}
    # the cell holds the numbers its limits name, of those its kind reads
    compared = {k: {"value": out.compared[k], "limit": lim["limit"]} for k, lim in limits.items()}
    correct = out.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    device = {"platform": "gpu" if run.device == "cuda" else run.device, "kind": _device_name(run.device),
              "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    if run.trace:
        device.update(busy_s=out.trace.busy_seconds() if out.trace else 0.0, window_s=out.traced_s)
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if run.trace and out.trace is not None:
        line["breakdown"] = {"device_ops": out.trace.top_device_ops(), "idle_gaps": out.trace.idle_gaps()}
    line["compared"] = compared
    return line


def _device_name(device: str) -> str:
    if device != "cuda":
        return device
    import torch

    return torch.cuda.get_device_name(0)


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(args, t0: float) -> int:
    import torch

    bench = Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    run = Run(bench, cell, bench.config(cell), bench.mix(cell), args.seed, args.seconds,
              bool(args.trace), "cuda", t0)
    line = run_cell(run)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    run.log("card:", _power_limit())
    for k, c in line["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
