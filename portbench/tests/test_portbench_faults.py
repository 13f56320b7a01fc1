"""A whole run on the CPU (the port's plain passes) at a tiny size: sound,
it comes out correct; with the timed step broken underneath, `correct`
comes out false, once for each fault the cell can have.  The cells run on
one card, so there is no exchange between cards to leave out.  The tiny
cell is a configuration, a traffic mix and a metric that exist only as
new files in a temporary directory, with entries in its BENCHMARK.json:
the harness finds them by name, and no file of portbench/ changes."""

import json
import os
import shutil
import time

import pytest
import torch

from conftest import make_bench
from harness import manifest
from harness.session import run_cell
from pseudoaligner_torch.ops import map_kernel

import run as entry


def _run(root, cache_dir, step=None, seconds=1.5, cell="tiny.cell"):
    man = manifest.load_manifest(root)
    c = manifest.cell(cell, man, os.path.join(root, "portbench"))
    r = run_cell(c, 2**31 + 3, seconds, False, "cpu", time.time(),
                 cache_dir=cache_dir, map_batch=step)
    readers = {m.name: manifest.reader(m.name, c.bench_dir)
               for m in c.end_to_end + c.per_layer}
    return r, entry.result_line(c, r, False, "cpu", readers)


@pytest.mark.parametrize("link", ["codes_u8", "packed_2bit"])
def test_sound_run_is_correct(tmp_path, cache_dir, link):
    make_bench(str(tmp_path), link=link)
    r, line = _run(str(tmp_path), cache_dir)
    assert line["correct"] is True
    assert r.judged > 0 and r.tally.done > 0
    assert set(line["metrics"]) == {"step_reads_per_s", "batch_p95_ms",
                                    "setup_s"}
    assert list(line)[-1] == "checks"
    assert line["checks"]["wrong_answers"] == {"value": 0, "limit": 0}


def _stale():
    """A step that returns its state unchanged: the first batch's outputs
    for every batch after it."""
    first = []

    def step(meta, idx, reads, lens):
        if not first:
            first.append(map_kernel.map_batch(meta, idx, reads, lens))
        return first[0]
    return step


def _half(meta, idx, reads, lens):
    """Half of the batch left out: only the first half is mapped."""
    h = reads.shape[0] // 2
    res = map_kernel.map_batch(meta, idx, reads, lens)
    part = map_kernel.map_batch(meta, idx, reads[:h], lens[:h])
    ec = torch.full_like(res.ec_distinct, -1)
    ec[:h] = part.ec_distinct
    cov = torch.zeros_like(res.coverage)
    cov[:h] = part.coverage
    mapped = torch.zeros_like(res.mapped)
    mapped[:h] = part.mapped
    return res._replace(ec_distinct=ec, coverage=cov, mapped=mapped)


def _altered(meta, idx, reads, lens):
    """An answer altered where it is produced: one read in 64 has its
    first class id off by one."""
    res = map_kernel.map_batch(meta, idx, reads, lens)
    ec = res.ec_distinct.clone()
    rows = torch.arange(0, ec.shape[0], 64)
    ec[rows, 0] = torch.where(ec[rows, 0] >= 0, ec[rows, 0] + 1,
                              ec[rows, 0])
    return res._replace(ec_distinct=ec)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_broken_step_is_not_correct(tiny_root, cache_dir, fault):
    step = {"stale": _stale(), "half": _half, "altered": _altered}[fault]
    r, line = _run(tiny_root, cache_dir, step)
    assert line["correct"] is False
    assert r.checks["wrong_answers"][0] > 0
    assert line["failed"] > 0


def test_new_config_traffic_and_metric_are_files(tmp_path, cache_dir):
    """A later cell, mix and metric: new files and new entries only."""
    root = str(tmp_path)
    man = make_bench(root)
    bench = os.path.join(root, "portbench")
    cfg = json.load(open(os.path.join(bench, "configs", "tiny.json")))
    cfg["seed_index"] = "mphf"
    json.dump(cfg, open(os.path.join(bench, "configs", "tiny-m.json"), "w"))
    with open(os.path.join(bench, "traffic", "odd.py"), "w") as f:
        f.write("def make(src, traffic, gen, out):\n"
                "    out.copy_(src.reads(len(out), out.shape[1], gen))\n")
    tr = json.load(open(os.path.join(bench, "traffic", "tiny-mix.json")))
    tr["generator"] = "odd"
    json.dump(tr, open(os.path.join(bench, "traffic", "odd-mix.json"), "w"))
    with open(os.path.join(bench, "metrics", "batches_done.py"), "w") as f:
        f.write("def read(run):\n    return run.tally.done\n")
    man["configs"].append(dict(man["configs"][0], name="tiny-m",
                               file="portbench/configs/tiny-m.json"))
    man["workloads"].append({"name": "tiny-m.odd", "config": "tiny-m",
                             "traffic": "odd-mix", "chips": 1, "why": "t"})
    man["end_to_end"].append({"name": "batches_done", "unit": "batches",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["tiny-m.odd"]})
    json.dump(man, open(os.path.join(root, "BENCHMARK.json"), "w"))
    r, line = _run(root, cache_dir, cell="tiny-m.odd")
    assert line["correct"] is True
    assert line["metrics"]["batches_done"]["value"] == r.tally.done > 0
    assert "step_reads_per_s" in line["metrics"]
    shutil.rmtree(root)
