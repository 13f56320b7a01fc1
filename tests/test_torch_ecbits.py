"""PyTorch port vs the JAX reference: the bitset EC intersection.

On a transcriptome of at most `bitset_tx_threshold` transcripts, each
class carries a bitset of its transcripts (`build_ec_bitsets`, uploaded as
`DeviceIndex.ec_bits`), and the full-output step ANDs the bitsets of each
read's classes into `MapResult.ec_bits`, which the record path decodes.
All exact."""

import numpy as np
import pytest
import torch

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.models.aligner import _MAP_STEP_JIT
from pseudoaligner_tpu.models.aligner import Pseudoaligner as RefAligner
from pseudoaligner_tpu.ops import map_kernel as ref_mk
from pseudoaligner_torch.config import AlignerConfig as PortConfig
from pseudoaligner_torch.models.aligner import Pseudoaligner
from pseudoaligner_torch.ops import map_kernel as mk

from .torch_helpers import (
    _fuzz_reads,
    assert_results_equal,
    build,
    family_transcripts,
    image_from_reference,
    make_batch,
    polyt_transcripts,
    port_index,
    write_fastq,
)


@pytest.fixture(scope="module")
def data():
    out = {}
    rng = np.random.default_rng(31)
    seqs, names, gmap = family_transcripts(rng)
    out[20] = (build(seqs, names, gmap, k=20),
               _fuzz_reads(rng, seqs, k=20, n=320, L=72))
    rng = np.random.default_rng(64)
    seqs, names, gmap = polyt_transcripts(rng)
    seqs2, _, _ = family_transcripts(rng, n_genes=2, n_iso=4)
    seqs += seqs2
    names += [f"f{i}" for i in range(len(seqs2))]
    gmap.update({f"f{i}": "FG" for i in range(len(seqs2))})
    out[64] = (build(seqs, names, gmap, k=64),
               _fuzz_reads(rng, seqs, k=64, n=200, L=96))
    return out


@pytest.mark.parametrize("k", [20, 64])
def test_bitsets_and_tx_words_match_reference(data, k):
    image, _ = data[k]
    for thresh in (16384, len(image.tx_names), len(image.tx_names) - 1, 0):
        cfg = AlignerConfig(k=k, max_read_len=96, pool_overlap=False,
                            bitset_tx_threshold=thresh)
        ref_dev, ref_meta = ref_mk.device_index_from_image(image, cfg)
        dev, meta = mk.device_index_from_image(
            image_from_reference(image), PortConfig(
                k=k, max_read_len=96, bitset_tx_threshold=thresh))
        assert meta.tx_words == ref_meta.tx_words
        assert meta.tx_words == (
            (len(image.tx_names) + 31) // 32
            if thresh >= len(image.tx_names) else 0)
        a, b = np.asarray(dev.ec_bits), np.asarray(ref_dev.ec_bits)
        assert a.dtype == b.dtype == np.uint32
        assert a.shape == b.shape and np.array_equal(a, b)
    bits = mk.build_ec_bitsets(image.ec_offsets, image.ec_txs,
                               len(image.tx_names))
    assert np.array_equal(bits, ref_mk.build_ec_bitsets(
        image.ec_offsets, image.ec_txs, len(image.tx_names)))
    # every class's bitset holds exactly its transcripts
    for e in range(image.n_ecs):
        got = np.nonzero(np.unpackbits(bits[e].view(np.uint8),
                                       bitorder="little"))[0]
        assert got.tolist() == image.ec_list(e).tolist()


CASES = {
    "k20_nodes8_mm2": (20, 72, dict(max_nodes=8, allowed_mismatches=2)),
    "k20_nodes64_mm2": (20, 72, dict(max_nodes=64, allowed_mismatches=2)),
    "k20_nodes8_mm0": (20, 72, dict(max_nodes=8, allowed_mismatches=0)),
    "k20_nodes64_mm0": (20, 72, dict(max_nodes=64, allowed_mismatches=0)),
    "k20_nodes3_overflow": (20, 72, dict(max_nodes=3)),
    "k64_nodes64": (64, 96, dict(max_nodes=64)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_map_result_ec_bits_match_reference(data, name):
    """MapResult.ec_bits of the port's plain full-output step equals the
    reference's map_batch_packed at distinct_cap = 0, on the same arrays."""
    k, L, kw = CASES[name]
    image, reads = data[k]
    reads = [(rid, w[:L]) for rid, w in reads]
    cfg = AlignerConfig(k=k, batch_size=len(reads), max_read_len=L,
                        distinct_cap=0, left_compact=0.0, pool_overlap=False,
                        **kw)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    assert meta.tx_words > 0
    codes, lens = make_batch(reads, len(reads) + 5, L)  # padding rows
    packed = ref_mk.pack_reads_host(codes)
    ref = _MAP_STEP_JIT(meta, dev_np, packed, lens)
    idx, pmeta = port_index(dev_np, meta)
    assert pmeta.tx_words == meta.tx_words and idx.ec_bits.shape[1] > 0
    got = mk.map_batch_packed(pmeta, idx,
                              torch.from_numpy(packed.view(np.int32)),
                              torch.from_numpy(lens))
    assert_results_equal(ref, got, name)
    bits = got.ec_bits.view(torch.int32)
    assert (bits[got.mapped] != 0).any() and (bits[~got.mapped] == 0).all()
    if name in ("k20_nodes8_mm2", "k20_nodes3_overflow"):
        # reads cross three or more classes; a 3-node buffer overflows
        ec = idx.node_row[got.nodes.clamp(min=0).long(), 3]
        n_cls = [len(set(ec[i][got.nodes[i] >= 0].tolist()))
                 for i in range(len(reads))]
        assert max(n_cls) >= 3
        assert (got.n_nodes > kw["max_nodes"]).any() == (
            name == "k20_nodes3_overflow")


def test_map_result_ec_bits_past_the_kept_classes_match_reference():
    """Reads crossing more distinct classes than K4 keeps on chip per read
    (16, csrc/ecbits.cu's C): a base transcript and 24 copies of it, each
    with one substitution, 3 bases after the last one, so that the class of
    the base's k-mers changes every few positions; reads of the base and
    of the copies at max_nodes 120 and the full output.  The port's
    MapResult, its ec_bits included, equals the reference's."""
    rng = np.random.default_rng(1717)
    base = rng.integers(0, 4, 300).astype(np.uint8)
    seqs = [base]
    for j in range(24):
        s = base.copy()
        s[100 + 3 * j] = (s[100 + 3 * j] + 1) % 4
        seqs.append(s)
    names = [f"t{j}" for j in range(len(seqs))]
    image = build(seqs, names, {n: "G" for n in names}, k=20)
    L = 96
    reads = [(f"r{i}", seqs[i % 5][st:st + L].copy())
             for i, st in enumerate(range(40, 200, 4))]
    cfg = AlignerConfig(k=20, batch_size=len(reads), max_read_len=L,
                        distinct_cap=0, left_compact=0.0, pool_overlap=False,
                        max_nodes=120)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    codes, lens = make_batch(reads, len(reads), L)
    packed = ref_mk.pack_reads_host(codes)
    ref = _MAP_STEP_JIT(meta, dev_np, packed, lens)
    idx, pmeta = port_index(dev_np, meta)
    got = mk.map_batch_packed(pmeta, idx,
                              torch.from_numpy(packed.view(np.int32)),
                              torch.from_numpy(lens))
    assert_results_equal(ref, got, "past_the_kept_classes")
    ec = idx.node_row[got.nodes.clamp(min=0).long(), 3]
    n_cls = [len(set(ec[i][got.nodes[i] >= 0].tolist()))
             for i in range(len(reads))]
    assert max(n_cls) > 16 and got.mapped.all()
    assert (got.n_nodes <= 120).all()


def test_ec_bitset_intersect_semantics():
    """The plain intersection from its definition: AND over the distinct
    classes of the first min(n_nodes, max_nodes) nodes, all-ones start,
    zeros for unmapped reads."""
    node_row = torch.zeros((6, 12), dtype=torch.int32)
    node_row[:, 3] = torch.tensor([0, 1, 2, 0, 1, 2])
    ec_bits = torch.tensor([[0b0111, -1], [0b0110, 5], [0b1100, -2]],
                           dtype=torch.int32)
    idx = mk.DeviceIndex(**{f: None for f in (
        "pool_rows", "cuckoo", "cuckoo_vals", "mphf_bits", "mphf_ranks",
        "kmer_keys", "kmer_node", "kmer_offset")}, node_row=node_row,
        ec_bits=ec_bits)
    meta = mk.MapMeta(k=20, read_len=64, allowed_mismatches=2,
                      left_extend_fraction=0.2, max_nodes=3, cuckoo_mask=0,
                      tx_words=2)
    nodes = torch.tensor([[0, 3, -1], [0, 1, -1], [1, 2, 5], [4, -1, -1],
                          [0, 1, 2]], dtype=torch.int32)
    n_nodes = torch.tensor([2, 2, 9, 1, 3], dtype=torch.int32)
    mapped = torch.tensor([True, True, True, True, False])
    got = mk.ec_bitset_intersect(meta, idx, nodes, n_nodes, mapped)
    assert got.tolist() == [[0b0111, -1], [0b0110, 5], [0b0100, 4],
                            [0b0110, 5], [0, 0]]


@pytest.mark.parametrize("k", [20, 64])
def test_records_from_bits_match_reference_and_csr(data, tmp_path, k):
    """The record path (map_fastq at the full-output shape) decodes the
    bitsets into the reference's records, and into the port's own host
    CSR records (bitset_tx_threshold = 0)."""
    image, reads = data[k]
    L = 72 if k == 20 else 96
    fq = str(tmp_path / "reads.fq")
    write_fastq(fq, reads)
    kw = dict(k=k, batch_size=64, max_read_len=L, distinct_cap=0,
              max_nodes=8)
    want = [r.format_reference_style()
            for r in RefAligner(image, AlignerConfig(**kw)).map_fastq(fq)]
    outs = {}
    for thresh in (16384, 0):
        al = Pseudoaligner(image, PortConfig(bitset_tx_threshold=thresh,
                                             **kw), device="cpu")
        assert (al.meta.tx_words > 0) == (thresh > 0)
        outs[thresh] = [r.format_reference_style() for r in al.map_fastq(fq)]
    assert outs[16384] == want and outs[0] == want
    assert len(want) == len(reads)
