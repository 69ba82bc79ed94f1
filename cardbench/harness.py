"""One run of one cell, driven by data.

``BENCHMARK.json`` names the cell's configuration, traffic and metrics;
the harness finds each by that name:

- ``cardbench/configs/<config>.json``: the configuration (the file that
  ``BENCHMARK.json``'s ``configs`` entry gives);
- ``cardbench/traffic/<traffic>.json``: the traffic, whose ``kind`` names
  the loop, ``cardbench/loops/<kind>.py``;
- ``cardbench/layer_metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx)`` returning the value or None (nothing to read), and where
  it needs ranges in the trace, ``annotate(model, annotations)``;
- ``cardbench/limits/<workload>.json``: the limit of each number that the
  cell's check compares.

A run: set-up (build the model, draw its weights on the device, warm up
every shape the traffic uses), the measured window, in a traced run the
profiled steps, then the check against the plain reference once the
program's state is freed.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import pathlib
import sys
import time

import torch

from cardbench import trace as tracing


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.spec = load_json(self.root / "BENCHMARK.json")
        self.dir = self.root / "cardbench"

    def _named(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"{key} has no entry named {name!r}")

    def cell(self, workload: str) -> dict:
        return self._named("workloads", workload)

    def config(self, cell: dict) -> dict:
        return load_json(self.root / self._named("configs",
                                                 cell["config"])["file"])

    def traffic(self, cell: dict) -> dict:
        return load_json(self.dir / "traffic" / f"{cell['traffic']}.json")

    def limits(self, workload: str) -> dict:
        return load_json(self.dir / "limits" / f"{workload}.json")["limits"]

    def metrics(self, group: str, workload: str) -> list:
        """The ``end_to_end`` or ``per_layer`` entries the cell reports."""
        return [m for m in self.spec[group]
                if workload in m.get("workloads", [workload])]

    def reader(self, name: str):
        path = self.dir / "layer_metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "cardbench_layer_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def loop(kind: str):
    return importlib.import_module(f"cardbench.loops.{kind}")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _device_info(device, count: int) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count, "memory_peak_bytes": 0}


def log(msg: str) -> None:
    print(f"cardbench: {msg}", file=sys.stderr, flush=True)


def check(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) of the compared numbers: each
    has to be finite and at most its limit."""
    compared = {k: {"value": float(v), "limit": float(limits[k])}
                for k, v in values.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in compared.values())
    return correct, compared


def run(root, workload: str, seed: int, seconds: float, traced: bool,
        device, t_start: float) -> dict:
    """One run of ``workload``; returns the result's fields.  ``t_start``:
    the host clock at the process's start, where set-up begins."""
    bench = Bench(root)
    cell = bench.cell(workload)
    cfg, traffic = bench.config(cell), bench.traffic(cell)
    limits = bench.limits(workload)
    kind = loop(traffic["kind"])
    cell_run = kind.Run(cfg, traffic, seed, device)
    cell_run.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window = cell_run.window(seconds)
    info = _device_info(device, cell["chips"])
    if torch.device(device).type == "cuda":
        info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    log(f"window {window['seconds']:.3f} s, {window['attempted']} done")

    result = {"attempted": window["attempted"], "failed": window["failed"]}
    if traced:
        readers = {m["name"]: bench.reader(m["name"])
                   for m in bench.metrics("per_layer", workload)}
        ann = tracing.Annotations()
        for r in readers.values():
            if hasattr(r, "annotate"):
                r.annotate(cell_run.model, ann)
        try:
            with tracing.captured(device) as got:
                with torch.profiler.record_function(tracing.PREFIX
                                                    + "traced"):
                    profiled = cell_run.traced()
        finally:
            ann.remove()
        tr = got["trace"]
        log(f"traced window {tr.wall_s:.3f} s, busy {tr.busy_s:.3f} s")
        ctx = {"cell": cell, "config": cfg, "traffic": traffic,
               "window": window, "traced": profiled, "trace": tr}
        metrics = {}
        for m in bench.metrics("per_layer", workload):
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info.update(busy_s=tr.busy_s, window_s=tr.wall_s)
        result["breakdown"] = tr.breakdown()
    else:
        e2e = dict(window["metrics"], setup_s=setup_s,
                   peak_mem_GB=info["memory_peak_bytes"] / 1e9)
        metrics = {}
        for m in bench.metrics("end_to_end", workload):
            metrics[m["name"]] = {"value": e2e[m["name"]],
                                  "unit": m["unit"]}

    got_readings = cell_run.readings
    cell_run.free()
    t_ref = time.perf_counter()
    want = cell_run.reference("float32")
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    correct, compared = check(kind.compare(got_readings, want), limits)
    correct = correct and window["failed"] == 0 and window["attempted"] > 0
    result.update(correct=correct, metrics=metrics, device=info,
                  compared=compared)
    return result
