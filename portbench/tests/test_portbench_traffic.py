"""The traffic generator: deterministic in the seed, as its file says."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH, TINY_RECIPE, TINY_TRAFFIC
from harness import traffic, transcriptome
from reference.graph import RefGraph, kmer_values


@pytest.fixture(scope="module")
def flat():
    seqs, _, _ = transcriptome.make(TINY_RECIPE)
    return transcriptome.Flat.of(seqs)


def _batch(flat, tr, seed):
    out = torch.zeros((tr["batch_reads"], tr["read_len"]), dtype=torch.uint8)
    rows = traffic.fill_ring(flat, tr, seed, [out], "cpu")
    return out.numpy(), rows


def test_transcriptome_keeps_the_published_counts():
    seqs, names, gene_map = transcriptome.make(TINY_RECIPE)
    assert len(seqs) == TINY_RECIPE["transcripts"]
    assert len(set(gene_map.values())) == TINY_RECIPE["genes"]
    rng = np.random.default_rng(0)
    n = transcriptome.isoform_counts(58381, 203835, rng)
    assert n.sum() == 203835 and n.min() >= 1 and len(n) == 58381


def test_same_seed_same_batch_other_seed_other_batch(flat):
    a, ra = _batch(flat, TINY_TRAFFIC, 2**31 + 7)
    b, rb = _batch(flat, TINY_TRAFFIC, 2**31 + 7)
    c, _ = _batch(flat, TINY_TRAFFIC, 11)
    assert np.array_equal(a, b) and np.array_equal(ra, rb)
    assert not np.array_equal(a, c)
    assert a.max() <= 3
    assert len(ra) == TINY_TRAFFIC["sample_reads"]
    assert len(np.unique(ra)) == len(ra)


def test_kinds_and_substitutions_match_the_file(flat):
    """Without errors, sense reads hold only the transcriptome's k-mers,
    antisense reads do once reverse-complemented, and unmapped ones hold
    neither; with errors, the same seed's batch differs at exactly the
    file's count of bases."""
    tr = dict(TINY_TRAFFIC, error_rate=0.0)
    c = traffic.counts(TINY_TRAFFIC)
    assert c == {"sense": 240, "antisense": 240, "unmapped": 120,
                 "substitutions": 108}
    g = RefGraph.build(flat.bases, flat.starts, 20)
    clean, _ = _batch(flat, tr, 5)
    sense = np.array([g.contains(kmer_values(r, 20)).all() for r in clean])
    anti = np.array([g.contains(kmer_values(3 - r[::-1], 20)).all()
                     for r in clean])
    assert sense.sum() == c["sense"] and anti.sum() == c["antisense"]
    assert (~(sense | anti)).sum() == c["unmapped"]
    noisy, _ = _batch(flat, TINY_TRAFFIC, 5)
    assert (noisy != clean).sum() == c["substitutions"]


def test_reads_follow_the_expression_law(flat):
    L = TINY_TRAFFIC["read_len"]
    ex = TINY_TRAFFIC["expression"]
    w = traffic.read_weights(flat.starts, L, ex)
    n = flat.n_tx
    rank = np.empty(n)
    rank[np.random.default_rng(ex["seed"]).permutation(n)] = np.arange(
        1, n + 1)
    windows = np.maximum(np.diff(flat.starts) - L + 1, 0)
    want = windows / rank
    assert np.allclose(w, want / want.sum())
    src = traffic.Source(flat, TINY_TRAFFIC, "cpu")
    tx, off = src.draw(20000, traffic.generator(3, "cpu"))
    seen = np.bincount(tx.numpy(), minlength=n) / 20000
    assert np.abs(seen - w).max() < 0.015
    assert (off.numpy() < windows[tx.numpy()]).all()
    tx, off = (t.numpy() for t in src.draw(50, traffic.generator(4, "cpu")))
    reads = src.reads(50, L, traffic.generator(4, "cpu")).numpy()
    for r, t, o in zip(reads, tx, off):
        assert np.array_equal(r, flat.seq(t)[o:o + L])


def test_cell_traffic_files_parse_and_cite():
    for name in os.listdir(os.path.join(BENCH, "traffic")):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(BENCH, "traffic", name)) as f:
            tr = json.load(f)
        c = traffic.counts(tr)
        assert c["sense"] + c["antisense"] + c["unmapped"] == tr["batch_reads"]
        assert tr["link"] in traffic.LINKS
        for key in ("unmapped_share", "antisense_share", "error_rate",
                    "expression", "read_len"):
            assert key in tr["sources"]


def test_packed_link_is_the_aligners_host_pack(tiny_root, cache_dir):
    """A packed ring slot is the program's host pack of the slot's codes:
    base i at bits 2 (i % 16) of word i // 16."""
    from harness import manifest
    from harness.build import Built
    from harness.session import _ring

    man = manifest.load_manifest(tiny_root)
    cell = manifest.cell("tiny.cell", man, os.path.join(tiny_root,
                                                        "portbench"))
    cell.traffic = dict(cell.traffic, link="packed_2bit")
    flat = Built(cell.config, cache_dir).flat()
    spans = {}
    codes, reads, *_ = _ring(cell, flat, 9, torch.device("cpu"), None, spans)
    assert spans["host_pack"] > 0
    for c, r in zip(codes, reads):
        words = r.numpy().view(np.uint32)
        L = c.shape[1]
        i = np.arange(L)
        back = (words[:, i // 16] >> (2 * (i % 16)).astype(np.uint32)) & 3
        assert np.array_equal(back, c.numpy())
