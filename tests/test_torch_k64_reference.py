"""The port's serving step at the reference CLI's k = 64 against the
benchmark's plain reference (portbench/reference/: the de Bruijn graph
rebuilt in NumPy from the transcripts, k-mers as (hi, lo) words, each
read walked in Python), on small seeded transcriptomes.

The step is the one `step-se150.k64` times: `serving_config(64, B, 150)`,
reads 2-bit packed on the host by `pack_reads_host`, then
`map_batch_packed`, here on the CPU (the plain PyTorch passes).  Every
compact output (class runs, coverage, mapped) must equal the
reference's, or carry the -3 or -2 flag where the reference's `expected`
allows it, under the cuckoo and the MPHF seed index.  The control, the
reference with the mismatch budget taken from 2 to 0, put in the step's
place, must be judged wrong.

This file imports no jax and no pseudoaligner_tpu.
"""

import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "portbench")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from harness import traffic, transcriptome  # noqa: E402
from harness.session import shape_of  # noqa: E402
from reference.answers import answers, control_outputs, wrong  # noqa: E402
from reference.graph import RefGraph  # noqa: E402

K, L, B = 64, 150, 600
# reads that stress the walk: substitutions at about 4 a read, antisense
# reads and reads from nowhere, over a tiny transcriptome with antisense
# chimeras (reads of the other strand seed mid-read) and repeated windows
TRAFFIC = {"read_len": L, "batch_reads": B, "sample_reads": 1,
           "unmapped_share": 0.05, "antisense_share": 0.25,
           "error_rate": 0.027,
           "expression": {"law": "zipf", "exponent": 0.5, "seed": 3}}


def _world(seed: int):
    """(index image, reference graph, [B, L] uint8 reads) of a tiny
    transcriptome made from `seed` by the benchmark's recipe."""
    from pseudoaligner_torch.index.builder import build_index

    seqs, names, gm = transcriptome.make(
        {"recipe": "gencode_counts", "seed": seed, "genes": 40,
         "transcripts": 130, "family_len": [200, 700],
         "deletion": [5, 60]})
    rng = np.random.default_rng(seed)
    extra = []
    for _ in range(20):
        a, b = (seqs[i] for i in rng.integers(len(seqs), size=2))
        extra.append(np.concatenate(
            [3 - a[::-1][:rng.integers(70, len(a))],
             b[rng.integers(0, len(b) // 2):]]).astype(np.uint8))
    for _ in range(6):
        a = seqs[rng.integers(len(seqs))]
        p = int(rng.integers(0, len(a) - 80))
        extra.append(np.concatenate([a[:p + 70], a[p:p + 70], a[p + 70:]]))
    seqs = seqs + extra
    names = names + [f"x{i}" for i in range(len(extra))]
    gm = dict(gm, **{f"x{i}": f"gx{i}" for i in range(len(extra))})
    flat = transcriptome.Flat.of(seqs)
    image = build_index(seqs, names, gm, k=K)
    g = RefGraph.build(flat.bases, flat.starts, K)
    reads = torch.zeros((B, L), dtype=torch.uint8)
    traffic.fill_ring(flat, TRAFFIC, seed, [reads], "cpu")
    return image, g, reads.numpy()


@pytest.fixture(scope="module", params=[5, 6], ids=lambda s: f"tx{s}")
def world(request):
    return _world(request.param)


def _serving_step(image, reads, seed_index):
    """(ec_distinct, coverage, mapped) of the serving step and its meta."""
    from pseudoaligner_torch.cli import serving_config
    from pseudoaligner_torch.models.aligner import Pseudoaligner
    from pseudoaligner_torch.ops import map_kernel

    al = Pseudoaligner(image, serving_config(K, B, L, seed_index=seed_index),
                       device="cpu")
    packed = torch.from_numpy(
        map_kernel.pack_reads_host(reads).view(np.int32))
    res = map_kernel.map_batch_packed(
        al.meta, al.dev, packed, torch.full((B,), L, dtype=torch.int32))
    return (res.ec_distinct.numpy(), res.coverage.numpy(),
            res.mapped.numpy()), al.meta


@pytest.mark.parametrize("answerer", ["cuckoo", "mphf", "control"])
def test_k64_serving_step_equals_the_reference(world, answerer):
    image, g, reads = world
    out, meta = _serving_step(image, reads,
                              "mphf" if answerer == "mphf" else "cuckoo")
    assert meta.k == K and meta.lazy_seeds == (answerer != "mphf")
    assert (meta.max_walk_iters, meta.max_left_iters,
            meta.distinct_cap) == (7, 2, 3)
    shape = shape_of(meta)
    ref = answers(g, reads, shape)
    assert ref.capped.any() and ref.mapped.any() and not ref.mapped.all()
    if answerer == "control":
        ctl = control_outputs(answers(g, reads, shape, allowed=0))
        assert wrong(ref, *ctl).sum() > 0.05 * B
        return
    ec = out[0]
    assert wrong(ref, *out).sum() == 0
    # -3 exactly where the reference says a cap cuts the walk
    assert np.array_equal(ec[:, -1] == -3, ref.capped)
