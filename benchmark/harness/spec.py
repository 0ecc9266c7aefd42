"""The benchmark's data, found by name: BENCHMARK.json, the configuration
files (configs/<name>.json), the traffic mixes (traffic/<name>.json), the
correctness limits of each cell (limits/<workload>.json) and the readers of
the per-layer metrics (metrics/<name>.py).  A later cell, rig or metric is
a new file here, never an edit."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark_json(root=ROOT):
    return _load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # limits/<name>.json: number -> limit
    end_to_end: list        # BENCHMARK.json metrics this cell reports
    per_layer: list
    chips: int


def _applies(metric, name):
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(name, root=ROOT):
    """The cell ``name`` of BENCHMARK.json with its files."""
    bench = benchmark_json(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError("no workload %r in BENCHMARK.json (have %s)"
                       % (name, sorted(cells)))
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic",
                                      w["traffic"] + ".json"))
    limits = _load_json(os.path.join(BENCH_DIR, "limits", name + ".json"))
    return Cell(name=name, config=conf, traffic=traffic,
                limits=limits["limits"],
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                chips=int(w["chips"]))


def reader(metric_name):
    """The ``read(record)`` function of metrics/<metric_name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
