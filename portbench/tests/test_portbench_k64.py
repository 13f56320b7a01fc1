"""The k = 64 cell, `step-se150.k64`: the harness takes it as data.  Its
configuration is the cuckoo one at the reference CLI's other k-mer size,
its traffic is `step-se150.cuckoo`'s, and its cache is its own."""

import pytest

from harness import build, manifest

CELL, SIBLING = "step-se150.k64", "step-se150.cuckoo"
# fields of a configuration that describe it in words, or name it
TEXT = {"name", "source", "deployment", "published", "assumed",
        "guarantees", "why_reduced"}


@pytest.fixture(scope="module")
def cells():
    return manifest.cell(CELL), manifest.cell(SIBLING)


def _numbers(cfg: dict) -> dict:
    return {key: v for key, v in cfg.items() if key not in TEXT}


def test_the_cell_resolves(cells):
    cell, _ = cells
    assert cell.chips == 1
    assert cell.config["k"] == 64 and cell.config["seed_index"] == "cuckoo"
    assert {m.name for m in cell.end_to_end} == {
        "step_reads_per_s", "batch_p95_ms", "setup_s"}
    names = {m.name for m in cell.per_layer}
    assert "serve_init_mib.plain_keys" in names
    for name in names:
        manifest.reader(name)  # every reader loads


def test_config_differs_from_the_cuckoo_one_only_in_k_and_words(cells):
    cell, sibling = cells
    ours, theirs = _numbers(cell.config), _numbers(sibling.config)
    assert ours.pop("k") == 64 and theirs.pop("k") == 20
    assert ours == theirs
    for key in ("published", "assumed"):
        assert cell.config[key].keys() == sibling.config[key].keys()
    assert ({key: v for key, v in cell.config["published"].items()
             if key != "where"}
            == {key: v for key, v in sibling.config["published"].items()
                if key != "where"})
    g, h = cell.config["guarantees"], sibling.config["guarantees"]
    assert g["stranded"] == h["stranded"] and g["answers"] == h["answers"]
    assert g["allowed_mismatches"] == h["allowed_mismatches"] == 2
    assert g["reference"].startswith("portbench/reference/")


def test_traffic_is_the_k20_cells(cells):
    cell, sibling = cells
    assert cell.traffic == sibling.traffic
    man = manifest.load_manifest()
    by_name = {w["name"]: w for w in man["workloads"]}
    assert by_name[CELL]["traffic"] == by_name[SIBLING]["traffic"]


def test_a_cache_directory_of_its_own(cells, tmp_path):
    cell, sibling = cells
    ours = build.Built(cell.config, str(tmp_path))
    theirs = build.Built(sibling.config, str(tmp_path))
    assert ours.k == 64 and theirs.k == 20
    assert ours.recipe == theirs.recipe
    assert ours.dir != theirs.dir
    mphf = manifest.cell("step-se75.mphf")
    assert build.Built(mphf.config, str(tmp_path)).dir == theirs.dir


def test_the_new_metric_lists_the_cell_alone():
    man = manifest.load_manifest()
    m = {e["name"]: e for e in man["per_layer"]}["serve_init_mib.plain_keys"]
    assert m["workloads"] == [CELL] and m["moves"] == "setup_s"
    assert m["source"] == "program_counter" and m["better"] == "lower"
    for e in man["per_layer"]:
        if SIBLING in e["workloads"]:
            assert e["workloads"][-1] == CELL, e["name"]


def test_the_reader_reads_the_counter_or_nothing():
    """None where the program counted no plain key rows (a parent without
    the counter); else the counter's bytes in MiB."""
    from pseudoaligner_torch import spans

    read = manifest.reader("serve_init_mib.plain_keys")
    spans.reset()
    assert read(None) is None
    spans.count("pa.serve_init.plain_key_bytes", 3 << 20)
    assert read(None) == 3.0
    spans.reset()
