"""PyTorch port vs the JAX reference: paired-end `map`.

The mates of a pair are mapped (both in one combined device batch on the
serving path), their classes intersected when both map, else the mapped
mate's class is taken, and coverage is summed.  Records, TCC files and
the CLI's stdout must be byte-identical to the reference's."""

import io
import os

import numpy as np
import pytest

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.models.aligner import Pseudoaligner as RefAligner
from pseudoaligner_tpu.serde import save_index
from pseudoaligner_torch import cli as port_cli
from pseudoaligner_torch.config import AlignerConfig as PortConfig
from pseudoaligner_torch.golden import golden_oracle, golden_pair_record
from pseudoaligner_torch.models.aligner import Pseudoaligner

from .torch_helpers import (
    _fuzz_reads,
    build,
    family_transcripts,
    make_batch,
    write_fastq,
)

# compact serving shape in which this workload both overflows the distinct
# slots (-2) and hits the walk cap (-3)
SERVING = dict(distinct_cap=2, max_walk_iters=4, max_left_iters=2,
               max_nodes=8)
N_PAIRS = 300


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Isoform families whose deletions cluster in one window (short
    unitigs of distinct classes: walks cross class boundaries, rows
    overflow to -2 and hit the caps, -3) and 300 fuzz pairs; every 5th
    mate2 is random noise, so flagged mate1s meet unmapped mate2s."""
    rng = np.random.default_rng(9001)
    seqs, names, gmap = family_transcripts(rng)
    image = build(seqs, names, gmap, k=20)
    reads1 = _fuzz_reads(rng, seqs, k=20, n=N_PAIRS, L=72)
    reads2 = [(rid, rng.integers(0, 4, 72).astype(np.uint8)) if i % 5 == 0
              else (rid, w) for i, (rid, w) in
              enumerate(_fuzz_reads(rng, seqs, k=20, n=N_PAIRS, L=72))]
    reads2 = [(r1[0], w) for r1, (_, w) in zip(reads1, reads2)]
    d = tmp_path_factory.mktemp("paired")
    r1, r2 = str(d / "p1.fq"), str(d / "p2.fq")
    write_fastq(r1, reads1)
    write_fastq(r2, reads2)
    idx = str(d / "index.bin")
    save_index(image, idx)
    return image, idx, r1, r2, (reads1, reads2), d


def _cli(main, argv, capsysbinary):
    rc = main(argv)
    return rc, capsysbinary.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--tcc"]])
def test_cli_paired_matches_reference(pairs, tmp_path, capsysbinary, extra):
    """`map -i IDX r1.fq r2.fq` at a batch size that splits the pairs into
    full and tail batches: the serving fast path, and with --tcc the
    record path and its output.ec / output.tsv."""
    from pseudoaligner_tpu import cli as ref_cli

    _, idx, r1, r2, _, _ = pairs
    base = ["map", "-i", idx, r1, r2, "--batch-size", "64",
            "--max-read-len", "80"]
    outs, dirs = {}, {}
    for tag, main, more in (("ref", ref_cli.main, []),
                            ("port", port_cli.main, ["--device", "cpu"])):
        dirs[tag] = str(tmp_path / tag)
        rc, outs[tag] = _cli(main, base + extra + more + ["-o", dirs[tag]],
                             capsysbinary)
        assert rc == 0, tag
    assert outs["port"] == outs["ref"]
    assert outs["port"].count(b"\n") == N_PAIRS
    if extra:
        for f in ("output.ec", "output.tsv"):
            with open(os.path.join(dirs["ref"], f), "rb") as a, \
                    open(os.path.join(dirs["port"], f), "rb") as b:
                assert b.read() == a.read(), f


def test_golden_pair_records_match_cli(pairs, capsysbinary):
    """The scalar oracle's pair records (the check chip_smoke.py makes on
    the card) equal the paired CLI's, pair for pair."""
    image, idx, r1, r2, (reads1, reads2), _ = pairs
    rc, out = _cli(port_cli.main, [
        "map", "-i", idx, r1, r2, "--batch-size", "64", "--max-read-len",
        "80", "--device", "cpu"], capsysbinary)
    assert rc == 0
    lines = out.split(b"\n")[:-1]
    assert len(lines) == N_PAIRS
    oracle = golden_oracle(image)
    cfg = PortConfig(k=20)
    for line, (rid, w1), (_, w2) in zip(lines, reads1, reads2):
        assert golden_pair_record(oracle, rid, w1, w2, cfg).encode() == line


def test_cli_paired_refuses_skip_reads(pairs, capsysbinary):
    from pseudoaligner_tpu import cli as ref_cli

    _, idx, r1, r2, _, _ = pairs
    argv = ["map", "-i", idx, r1, r2, "--skip-reads", "3"]
    want = _cli(ref_cli.main, argv, capsysbinary)
    got = _cli(port_cli.main, argv + ["--device", "cpu"], capsysbinary)
    assert got == want and got[0] == 1
    assert b"not supported in paired mode" in got[1]


def _records(recs):
    return "".join(r.format_reference_style() + "\n" for r in recs).encode()


@pytest.mark.parametrize("threshold", [16384, 0])
def test_emit_paired_matches_records(pairs, threshold):
    """The serving emit (combined 2h-row batches, signature groups, -2/-3
    override rows through the batched intersection) equals the port's
    full-output paired records, and both equal the reference's; the
    records use the bitset EC path (threshold 16,384) or the host CSR
    intersection (threshold 0)."""
    image, _, r1, r2, (reads1, mates2), _ = pairs
    full = dict(k=20, batch_size=128, max_read_len=80, max_nodes=64,
                distinct_cap=0, bitset_tx_threshold=threshold)
    want = _records(RefAligner(image, AlignerConfig(**full))
                    .map_fastq_paired(r1, r2))
    rec_al = Pseudoaligner(image, PortConfig(**full), device="cpu")
    assert (rec_al.meta.tx_words > 0) == (threshold > 0)
    assert _records(rec_al.map_fastq_paired(r1, r2)) == want

    srv = Pseudoaligner(image, PortConfig(k=20, batch_size=128,
                                          max_read_len=80, **SERVING),
                        device="cpu")
    # the workload really has overflow (-2) and capped (-3) rows
    flags = set()
    for reads in (reads1, mates2):
        for i in range(0, N_PAIRS, 128):
            codes, lens = make_batch(reads[i:], 128, 80)
            flags |= set(srv.map_batch_device(codes, lens)
                         .ec_distinct[:, -1].tolist())
    assert {-2, -3} <= flags
    buf = io.BytesIO()
    try:
        assert srv.emit_fastq_paired(r1, r2, buf) == N_PAIRS
    finally:
        srv.close()
    assert buf.getvalue() == want


def test_mismatched_mate_counts_raise(pairs):
    image, _, r1, _, (_, reads2), d = pairs
    short = str(d / "short2.fq")
    write_fastq(short, reads2[:N_PAIRS - 7])
    for kw in (SERVING, dict(distinct_cap=0, max_nodes=64)):
        al = Pseudoaligner(image, PortConfig(k=20, batch_size=64,
                                             max_read_len=80, **kw),
                           device="cpu")
        with pytest.raises(ValueError, match="different read counts"):
            al.emit_fastq_paired(r1, short, io.BytesIO())
        with pytest.raises(ValueError, match="different read counts"):
            list(al.map_fastq_paired(r1, short))
        al.close()
