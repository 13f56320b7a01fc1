"""The benchmark's CPU tests: portbench/ and the repository's root on the
path, and a tiny benchmark directory (configurations, traffic, metric
readers, BENCHMARK.json) made in a temporary directory."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_RECIPE = {"recipe": "gencode_counts", "seed": 3, "genes": 24,
               "transcripts": 70, "family_len": [150, 600],
               "deletion": [5, 40]}
TINY_TRAFFIC = {"generator": "windows", "read_len": 75, "batch_reads": 600,
                "in_flight": 2, "ring_batches": 2, "sample_reads": 200,
                "unmapped_share": 0.2, "antisense_share": 0.5,
                "error_rate": 0.0024,
                "expression": {"law": "zipf", "exponent": 1.0, "seed": 1}}


def make_bench(root: str, seed_index: str = "cuckoo",
               link: str = "codes_u8") -> dict:
    """A benchmark directory under `root` holding one tiny cell "tiny" (a
    configuration and a traffic mix of its own) and every metric reader of
    the real benchmark; returns its manifest."""
    bench = os.path.join(root, "portbench")
    os.makedirs(os.path.join(bench, "configs"))
    os.makedirs(os.path.join(bench, "traffic"))
    shutil.copytree(os.path.join(BENCH, "metrics"),
                    os.path.join(bench, "metrics"))
    cfg = {"name": "tiny", "k": 20, "seed_index": seed_index,
           "genes": TINY_RECIPE["genes"],
           "transcripts": TINY_RECIPE["transcripts"],
           "transcriptome": TINY_RECIPE, "reduced": []}
    with open(os.path.join(bench, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "tiny-mix.json"), "w") as f:
        json.dump(dict(TINY_TRAFFIC, link=link), f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    man = dict(real)
    man["configs"] = [{"name": "tiny", "source": "https://example.org/tiny",
                       "file": "portbench/configs/tiny.json",
                       "reduced": [], "why": "test"}]
    man["workloads"] = [{"name": "tiny.cell", "config": "tiny",
                         "traffic": "tiny-mix", "chips": 1, "why": "test"}]
    # what the tiny cell never reaches: the host pack (a packed link only),
    # the packed upload (its tables are under map_kernel.PACK_MIN_BYTES)
    # and the cuckoo table (cuckoo only)
    skip = {"serve_init_s.pack", "serve_init_s.unpack"}
    if link != "packed_2bit":
        skip.add("host_pack_ms_per_batch")
    if seed_index != "cuckoo":
        skip.add("serve_init_s.table")
    for m in man["per_layer"]:
        m["workloads"] = [] if m["name"] in skip else ["tiny.cell"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return man


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    make_bench(root)
    return root


@pytest.fixture(scope="session")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cache"))
