"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (configs/<config>.json) and a traffic mix
(traffic/<traffic>.json); each metric has a reader metrics/<name>.py with a
`read(run) -> float | None`.  Adding a configuration, a mix or a metric is
adding its file and its entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Metric:
    name: str
    unit: str
    moves: str | None  # per-layer: the end-to-end metric it should move
    workloads: list | None  # the cells that report it; None: every cell

    def in_cell(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list  # of Metric
    per_layer: list  # of Metric
    bench_dir: str = BENCH_DIR  # where its files were found


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def traffic_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "traffic", name + ".json")


def metric_path(name: str, bench_dir: str = BENCH_DIR) -> str:
    return os.path.join(bench_dir, "metrics", name + ".py")


def _metric(m: dict) -> Metric:
    return Metric(m["name"], m["unit"], m.get("moves"), m.get("workloads"))


def cell(name: str, manifest: dict | None = None,
         bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` with its configuration, traffic and metrics."""
    manifest = load_manifest() if manifest is None else manifest
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = _load_json(os.path.join(os.path.dirname(bench_dir),
                                     cfg_entry["file"]))
    traffic = _load_json(traffic_path(w["traffic"], bench_dir))
    e2e = [_metric(m) for m in manifest["end_to_end"]]
    pl = [_metric(m) for m in manifest["per_layer"]]
    return Cell(name, config, traffic, int(w["chips"]),
                [m for m in e2e if m.in_cell(name)],
                [m for m in pl if m.in_cell(name)], bench_dir)


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The `read` function of metrics/<name>.py."""
    path = metric_path(name, bench_dir)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
