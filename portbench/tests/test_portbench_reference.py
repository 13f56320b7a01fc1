"""The plain reference against the port's CPU path (device="cpu", the
plain PyTorch passes) on a tiny transcriptome built to stress the walk:
short gene families with 3.3 isoforms a gene, antisense chimeras (so reads
of the other strand seed mid-read) and repeated windows; reads with two
substitutions a read on average, of either strand, and from nowhere; the
serving caps and two tighter and looser ones, under each seed index."""

import dataclasses

import numpy as np
import pytest
import torch

from harness import traffic, transcriptome
from reference.answers import answers, control_outputs, wrong
from reference.graph import RefGraph
from harness.session import shape_of as _shape

RECIPE = {"recipe": "gencode_counts", "seed": 1, "genes": 80,
          "transcripts": 260, "family_len": [80, 400], "deletion": [5, 40]}


def _world(k: int, L: int):
    from pseudoaligner_torch.index.builder import build_index

    seqs, names, gm = transcriptome.make(RECIPE)
    rng = np.random.default_rng(1)
    extra = []
    for _ in range(40):
        a = seqs[rng.integers(len(seqs))]
        b = seqs[rng.integers(len(seqs))]
        extra.append(np.concatenate(
            [3 - a[::-1][:rng.integers(20, len(a))],
             b[rng.integers(0, len(b) // 2):]]).astype(np.uint8))
    for _ in range(10):
        a = seqs[rng.integers(len(seqs))]
        p = int(rng.integers(0, len(a) - 30))
        extra.append(np.concatenate([a[:p + 25], a[p:p + 25], a[p + 25:]]))
    seqs = seqs + extra
    names = names + [f"x{i}" for i in range(len(extra))]
    gm = dict(gm, **{f"x{i}": f"gx{i}" for i in range(len(extra))})
    flat = transcriptome.Flat.of(seqs)
    image = build_index(seqs, names, gm, k=k)
    g = RefGraph.build(flat.bases, flat.starts, k)
    tr = {"read_len": L, "batch_reads": 2000, "sample_reads": 1,
          "unmapped_share": 0.05, "antisense_share": 0.25,
          "error_rate": 0.027,
          "expression": {"law": "zipf", "exponent": 0.5, "seed": 3}}
    reads = torch.zeros((2000, L), dtype=torch.uint8)
    traffic.fill_ring(flat, tr, 2, [reads], "cpu")
    return image, g, reads.numpy()


@pytest.fixture(scope="module")
def world():
    return _world(20, 75)


@pytest.fixture(scope="module")
def world64():
    """k = 64, the reference CLI's other k-mer size, read at 150 bases."""
    return _world(64, 150)


def test_graph_matches_the_ports_index(world):
    image, g, _ = world
    assert image.n_nodes == len(g.node_len)
    assert image.mphf.n_keys == g.n_kmers
    assert sorted(np.asarray(image.node_ec).tolist()) == sorted(
        g.node_ec.tolist())
    assert sorted(np.asarray(image.node_len).tolist()) == sorted(
        g.node_len.tolist())


def _equals_the_ports_cpu_path(world, seed_index, caps):
    from pseudoaligner_torch.cli import serving_config
    from pseudoaligner_torch.models.aligner import Pseudoaligner
    from pseudoaligner_torch.ops import map_kernel

    image, g, reads = world
    B, L = reads.shape
    cfg = serving_config(g.k, B, L, seed_index=seed_index)
    if caps is not None:
        w, lc, dc = caps
        cfg = dataclasses.replace(cfg, max_walk_iters=w, max_left_iters=lc,
                                  distinct_cap=dc, max_nodes=w + lc + 2)
    al = Pseudoaligner(image, cfg, device="cpu")
    res = map_kernel.map_batch(al.meta, al.dev, torch.from_numpy(reads),
                               torch.full((B,), L, dtype=torch.int32))
    ref = answers(g, reads, _shape(al.meta))
    ec = res.ec_distinct.numpy()
    bad = wrong(ref, ec, res.coverage.numpy(), res.mapped.numpy())
    assert bad.sum() == 0
    # the -3 flags are exactly the reads the reference says a cap cuts
    assert np.array_equal(ec[:, -1] == -3, ref.capped)
    assert ref.capped.any() and ref.mapped.any() and not ref.mapped.all()


@pytest.mark.parametrize("seed_index", ["cuckoo", "mphf", "bucket1"])
@pytest.mark.parametrize("caps", [None, (2, 1, 2), (6, 3, 5)])
def test_reference_equals_the_ports_cpu_path(world, seed_index, caps):
    _equals_the_ports_cpu_path(world, seed_index, caps)


@pytest.mark.parametrize("seed_index", ["cuckoo", "mphf"])
def test_reference_equals_the_ports_cpu_path_at_k64(world64, seed_index):
    """Two-word k-mers in the reference against the port's W = 4 path,
    at the serving caps of 150-base reads (forward 7, left 2, 3 slots)."""
    _equals_the_ports_cpu_path(world64, seed_index, None)


def _control_fails(world):
    from pseudoaligner_torch.cli import serving_config
    from pseudoaligner_torch.models.aligner import Pseudoaligner

    image, g, reads = world
    al = Pseudoaligner(image, serving_config(g.k, *reads.shape),
                       device="cpu")
    shape = _shape(al.meta)
    ref = answers(g, reads, shape)
    ctl = answers(g, reads, shape, allowed=0)
    assert wrong(ref, *control_outputs(ctl)).sum() > 0.05 * len(reads)


def test_the_control_fails(world):
    """The reference with the per-segment mismatch budget taken to 0 (an
    exact-match walk), put in the program's place, is judged wrong."""
    _control_fails(world)


def test_the_control_fails_at_k64(world64):
    _control_fails(world64)
