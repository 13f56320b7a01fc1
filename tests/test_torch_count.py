"""PyTorch port vs the JAX reference: single-cell `count`.

R1 carries a cell barcode and a UMI, R2 the cDNA that is mapped.  The
port's `count_single_cell` (its batched path over compact signatures, and
its record path over full outputs with the bitset EC intersection) and
its `count` CLI must give the reference's cells, classes, molecule counts
and totals, and byte-identical output files."""

import os

import numpy as np
import pytest

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.models.aligner import Pseudoaligner as RefAligner
from pseudoaligner_tpu.serde import save_index
from pseudoaligner_tpu.singlecell import (
    Chemistry as RefChemistry,
    Whitelist as RefWhitelist,
    count_single_cell as ref_count,
)
from pseudoaligner_torch import cli as port_cli
from pseudoaligner_torch.config import AlignerConfig as PortConfig
from pseudoaligner_torch.models.aligner import Pseudoaligner
from pseudoaligner_torch.singlecell import (
    Chemistry,
    Whitelist,
    count_single_cell,
)

from .torch_helpers import _fuzz_reads, _random_transcripts, build

DEC = "ACGT"
PATHS = {
    # the batched path over compact signatures (the CLI's serving shape)
    "batched": dict(distinct_cap=3, max_walk_iters=3, max_left_iters=2,
                    max_nodes=8),
    # the record path over full outputs; the bitset EC path is on
    "records": dict(distinct_cap=0, max_nodes=64),
}


def _write_pairs(path1, path2, r1_seqs, r2_reads):
    with open(path1, "w") as f1, open(path2, "w") as f2:
        for i, (s1, (_, w)) in enumerate(zip(r1_seqs, r2_reads)):
            s2 = "".join(DEC[b] for b in w)
            f1.write(f"@p{i}\n{s1}\n+\n{'I' * len(s1)}\n")
            f2.write(f"@p{i}\n{s2}\n+\n{'I' * len(s2)}\n")


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """One index and two R1/R2 sets.

    "knee": 16-base barcodes from a pool of 30 cells with zipf-skewed
    abundance, 12-base UMIs, 5% one-Hamming barcode errors and a few short
    R1s (the knee call and the fold have structure).  "wl": 8-base barcodes
    from a 24-barcode whitelist, 6-base UMIs; 30% carry a one-Hamming
    error, 10% are random, 5% hold an N."""
    rng = np.random.default_rng(777)
    seqs, names, gmap = _random_transcripts(rng, n=10, lo=300, hi=700)
    image = build(seqs, names, gmap, k=20)
    d = tmp_path_factory.mktemp("count")
    idx = str(d / "index.bin")
    save_index(image, idx)
    n = 500

    cells = rng.integers(0, 4, (30, 16))
    w = 1.0 / np.arange(1, 31)
    bcs = cells[rng.choice(30, size=n, p=w / w.sum())]
    err = rng.random(n) < 0.05
    pos = rng.integers(0, 16, n)
    bcs[err, pos[err]] = (bcs[err, pos[err]] + rng.integers(1, 4, err.sum())
                          ) % 4
    knee_r1 = ["".join(DEC[b] for b in bc) + "".join(
        DEC[b] for b in rng.integers(0, 4, 12)) for bc in bcs]
    for i in range(0, n, 97):
        knee_r1[i] = knee_r1[i][:20]  # too short for barcode + UMI

    BC = 8
    wl_bcs = sorted({"".join(DEC[int(b)] for b in rng.integers(0, 4, BC))
                     for _ in range(24)})
    wl_r1 = []
    for _ in range(n):
        bc = list(wl_bcs[int(rng.integers(len(wl_bcs)))])
        r = rng.random()
        if r < 0.3:
            bc[int(rng.integers(BC))] = DEC[int(rng.integers(4))]
        elif r < 0.4:
            bc = [DEC[int(b)] for b in rng.integers(0, 4, BC)]
        elif r < 0.45:
            bc[int(rng.integers(BC))] = "N"
        wl_r1.append("".join(bc) + "".join(
            DEC[int(b)] for b in rng.integers(0, 4, 6)))
    wl_path = str(d / "whitelist.txt")
    with open(wl_path, "w") as f:
        f.write("\n".join(wl_bcs) + "\n")

    r2 = _fuzz_reads(rng, seqs, k=20, n=n, L=72)
    files = {}
    for tag, r1 in (("knee", knee_r1), ("wl", wl_r1)):
        files[tag] = (str(d / f"{tag}_1.fq"), str(d / f"{tag}_2.fq"))
        _write_pairs(*files[tag], r1, r2)
    return image, idx, files, wl_path


def _summary(c):
    return (c.cells, c.classes, c.entry_counts(),
            c.entry_counts("directional"), c.n_reads, c.n_mapped,
            c.n_bad_r1, c.n_corrected, c.n_bad_barcode)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("tag", ["knee", "wl"])
def test_count_matches_reference(workload, path, tag):
    """Both count paths, with a whitelist (exact, corrected and dropped
    barcodes) and without one (knee call, then the one-Hamming fold)."""
    image, _, files, wl_path = workload
    kw = dict(k=20, batch_size=64, max_read_len=80, **PATHS[path])
    if tag == "wl":
        chem_kw = dict(bc_len=8, umi_len=6)
        ref_wl = RefWhitelist.load(wl_path, 8)
        port_wl = Whitelist.load(wl_path, 8)
    else:
        chem_kw, ref_wl, port_wl = {}, None, None
    want = ref_count(RefAligner(image, AlignerConfig(**kw)), *files[tag],
                     RefChemistry(**chem_kw), whitelist=ref_wl)
    al = Pseudoaligner(image, PortConfig(**kw), device="cpu")
    assert al.meta.tx_words > 0  # the record path reads the bitsets
    try:
        got = count_single_cell(al, *files[tag], Chemistry(**chem_kw),
                                whitelist=port_wl)
    finally:
        al.close()
    assert _summary(got) == _summary(want)
    assert got.n_mapped > 0 and len(got.classes) > 1
    if tag == "wl":
        assert got.n_corrected > 0 and got.n_bad_barcode > 0
    else:
        assert got.n_corrected > 0 and got.n_bad_r1 > 0  # folded, short


def test_count_batched_equals_records(workload):
    """On the port alone, the batched path's counts equal the record
    path's (chip_smoke.py makes the same check on the card)."""
    image, _, files, _ = workload
    out = []
    for path in PATHS:
        al = Pseudoaligner(image, PortConfig(k=20, batch_size=64,
                                             max_read_len=80, **PATHS[path]),
                           device="cpu")
        out.append(_summary(count_single_cell(al, *files["knee"])))
        al.close()
    assert out[0] == out[1]


@pytest.mark.parametrize("extra", [[], ["--call-cells"], ["--whitelist"]])
def test_count_cli_matches_reference(workload, tmp_path, extra):
    """`count -i IDX R1 R2 -o DIR`: barcodes.tsv, ec.tsv, matrix.mtx (and
    cells.tsv) byte-identical to the reference CLI's."""
    from pseudoaligner_tpu import cli as ref_cli

    _, idx, files, wl_path = workload
    if extra == ["--whitelist"]:
        r1, r2 = files["wl"]
        extra = ["--whitelist", wl_path, "--bc-len", "8", "--umi-len", "6",
                 "--umi-dedup", "directional"]
    else:
        r1, r2 = files["knee"]
    names = ["barcodes.tsv", "ec.tsv", "matrix.mtx"]
    if "--call-cells" in extra:
        names.append("cells.tsv")
    got = {}
    for tag, main, more in (("ref", ref_cli.main, []),
                            ("port", port_cli.main, ["--device", "cpu"])):
        d = str(tmp_path / tag)
        assert main(["count", "-i", idx, r1, r2, "-o", d, "--batch-size",
                     "64", "--max-read-len", "80"] + extra + more) == 0
        got[tag] = {}
        for f in names:
            with open(os.path.join(d, f), "rb") as fh:
                got[tag][f] = fh.read()
    assert got["port"] == got["ref"]
    assert got["port"]["matrix.mtx"].count(b"\n") > 10
