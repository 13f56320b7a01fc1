"""BENCHMARK.json keeps to the benchmark's contract: names and units of the
allowed characters, every per-layer metric's `moves` reported in each of
its cells, chips, files under `paths`, bounds and the check's time."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT
from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def man():
    return manifest.load_manifest(ROOT)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_command(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in man["command"])
    assert 1 <= len(man["paths"]) <= 16
    assert all(PATH.match(p) and os.path.isdir(os.path.join(ROOT, p))
               for p in man["paths"])
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    runs = 2 + 14 * 24
    assert (runs * (man["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)
    assert len(json.dumps(man)) <= 64 * 1024


def test_names_units_and_entries(man):
    names = [c["name"] for c in man["configs"]]
    names += [w["name"] for w in man["workloads"]]
    names += [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(manifest.metric_path(m["name"]))
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in man["end_to_end"]}[
        "setup_s"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)


def test_configs_are_files_under_paths(man):
    used = {w["config"] for w in man["workloads"]}
    files = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            body = json.load(f)
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in body for k in c["reduced"])
        assert body["reduced"] == c["reduced"]
    for w in man["workloads"]:
        assert os.path.exists(manifest.traffic_path(w["traffic"]))


def test_every_cell_reports_what_it_must(man):
    layers = {}
    for w in man["workloads"]:
        cell = manifest.cell(w["name"], man)
        e2e = {m.name for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m.moves in e2e
    for m in man["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in man["workloads"]}
    # metrics of one layer give the same layer, letter for letter
    assert all(len(v) == 1 for v in layers.values())


def test_perf_md_names_every_layer(man):
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in man["per_layer"]:
        assert m["layer"] in perf


def test_bench_dir_holds_only_the_benchmark():
    top = set(os.listdir(BENCH)) - {".cache", "__pycache__"}
    assert top == {".gitignore", "run.py", "harness", "reference", "configs",
                   "traffic", "metrics", "tests", "control.py"}
