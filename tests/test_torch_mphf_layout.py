"""PyTorch port vs the JAX reference: the MPHF probers' device layouts.

The upload keeps each MPHF level word's bit word and rank word side by
side in one [bw, 2] tensor (`mphf_bits` and `mphf_ranks` its columns), and
a k-mer-partitioned shard keeps each slot's key words, node and offset in
one record (`keys` and `values` its column ranges).  The views hold the
image's and build_sharded_lookup's arrays, the bytes stay those of the
separate arrays at W = 2, and the plain probes on the new upload equal the
reference, on query sets whose all-zero rows (the send buffers' padding)
are the poly-A k-mer both where it is a key and where it is not."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.ops import map_kernel as ref_mk
from pseudoaligner_tpu.ops.mphf_lookup import (
    mphf_probe_dynamic as ref_probe_dynamic,
)
from pseudoaligner_tpu.ops.stats import batch_stats as ref_batch_stats
from pseudoaligner_tpu.parallel.sharded_index import (
    build_sharded_lookup as ref_build_lookup,
)
from pseudoaligner_torch.ops import map_kernel as mk
from pseudoaligner_torch.ops import stats
from pseudoaligner_torch.ops.mphf_lookup import dynamic_verified_lookup
from pseudoaligner_torch.parallel import sharded_index as si

from .torch_helpers import (
    build,
    family_transcripts,
    from_jax_device_index,
    image_from_reference,
    make_batch,
    polyt_transcripts,
    port_index,
)

L = {20: 64, 64: 96}


@pytest.fixture(scope="module", params=[(20, True), (20, False),
                                        (64, False)],
                ids=["k20-polyA-key", "k20-no-polyA", "k64"])
def case(request):
    """(k, reference image, whether the all-zero k-mer is a key): random
    transcripts with a poly-T run (its k-mers are not all-zero: the index
    keeps k-mers as read) and one with a 120-base poly-A run, or isoform
    families without either."""
    k, polya = request.param
    rng = np.random.default_rng(900 + k + polya)
    if polya:
        seqs, names, gmap = polyt_transcripts(rng)
        polya_tx = np.zeros(160, np.uint8)
        polya_tx[:20] = rng.integers(1, 4, 20)
        polya_tx[140:] = rng.integers(1, 4, 20)
        seqs, names = seqs + [polya_tx], names + ["POLYA"]
        gmap["POLYA"] = "GPA"
    else:
        seqs, names, gmap = family_transcripts(rng, n_genes=3, n_iso=4)
    image = build(seqs, names, gmap, k=k)
    has_zero = bool(np.all(image.kmer_keys == 0, axis=1).any())
    assert has_zero == polya
    return k, image, polya


def _queries(image, rng, n_zero=500):
    """Every key, random aliens of the key width, and n_zero all-zero
    rows, shuffled: [n, W] uint32."""
    keys = image.kmer_keys
    W = keys.shape[1]
    aliens = rng.integers(0, 2**32, (300, W), dtype=np.uint64).astype(
        np.uint32)
    top = 2 * image.k - 32 * (W - 1)
    aliens[:, -1] &= np.uint32((1 << top) - 1 if top < 32 else 0xFFFFFFFF)
    q = np.concatenate([keys, aliens, np.zeros((n_zero, W), np.uint32)])
    return q[rng.permutation(len(q))]


def test_upload_pairs_hold_the_image_words(case):
    """The main index's upload, whole and as the MPHF serving index: one
    [bw, 2] tensor whose columns are the image's bits and ranks, the
    same bytes as the two arrays."""
    k, image, _ = case
    cfg = AlignerConfig(k=k, max_read_len=L[k], seed_index="mphf",
                        pool_overlap=False)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    pdev, pmeta = from_jax_device_index(dev_np, meta)
    for up in (mk.upload(pdev, "cpu"), mk.upload(pdev, "cpu",
                                                 serving=pmeta)):
        pairs = up.mphf_pairs
        assert pairs.shape == (len(image.mphf.bits), 2)
        assert pairs.is_contiguous() and pairs.dtype == torch.int32
        assert np.array_equal(pairs[:, 0].numpy().view(np.uint32),
                              image.mphf.bits)
        assert np.array_equal(pairs[:, 1].numpy().view(np.uint32),
                              image.mphf.ranks)
        assert np.array_equal(up.mphf_bits.numpy().view(np.uint32),
                              image.mphf.bits)
        assert np.array_equal(up.mphf_ranks.numpy().view(np.uint32),
                              image.mphf.ranks)
        assert up.mphf_bits.data_ptr() == pairs.data_ptr()
        # nbytes counts the pair and record storages once: the bytes of
        # the arrays, and at W != 2 the records' zero padding
        names = [f.name for f in dataclasses.fields(mk.DeviceIndex)]
        nk, W = image.kmer_keys.shape
        pad = nk * 4 * (mk.record_words(W) - W - 2)
        assert up.nbytes() == sum(getattr(up, n).numel() * 4
                                  for n in names) + pad
        assert up.nbytes() == sum(np.asarray(getattr(pdev, n)).nbytes
                                  for n in names) + pad


@pytest.mark.parametrize("S", [1, 2, 4])
def test_shard_upload_layouts_hold_the_lookup(case, S):
    """Each shard of build_sharded_lookup, uploaded: pairs whose columns
    are its bits and ranks, records whose column ranges are its keys and
    values (zero padding after them), and the bytes of the separate
    arrays at W = 2 (a record is 16 bytes); 32-byte records at k = 64."""
    k, image, _ = case
    pimage = image_from_reference(image)
    lookup, _n_levels = si.build_sharded_lookup(pimage, S)
    W = image.kmer_keys.shape[1]
    rw = mk.record_words(W)
    assert rw == (4 if W <= 2 else 8)
    for s in range(S):
        port = si.upload_lookup(lookup, s, "cpu")
        for f in lookup._fields:
            got = getattr(port, f).numpy()
            want = getattr(lookup, f)[s]
            assert np.array_equal(got.view(want.dtype), want), f
        pairs, rec = port.pairs, port.records
        assert pairs.shape == (lookup.bits.shape[1], 2)
        assert rec.shape == (lookup.keys.shape[1], rw)
        assert rec.is_contiguous() and pairs.is_contiguous()
        assert port.keys.data_ptr() == rec.data_ptr()
        assert not rec[:, W + 2:].any()
        separate = sum(getattr(lookup, f)[s].nbytes for f in lookup._fields)
        pad = lookup.keys.shape[1] * 4 * (rw - W - 2)
        assert port.nbytes() == separate + pad
        if W == 2:
            assert pad == 0


def test_paired_layouts_refuse_separate_tensors():
    """The kernels' views of the pairs and records exist only over one
    storage; separate tensors are refused, not copied."""
    bits = torch.arange(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="columns"):
        mk.paired(bits, bits.clone())
    a, b = mk.paired_upload(np.arange(6, dtype=np.uint32),
                            np.arange(6, 12, dtype=np.uint32), "cpu")
    assert mk.paired(a, b).tolist() == [[i, 6 + i] for i in range(6)]
    assert mk.paired(a[:0], b[:0]).shape == (0, 2)
    lk = si.ShardedLookup(a, b, *(torch.zeros(1, dtype=torch.int32),) * 4,
                          torch.zeros((3, 2), dtype=torch.int32),
                          torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="record"):
        lk.records


@pytest.mark.parametrize("S", [1, 2, 4])
def test_dynamic_lookup_on_records_matches_reference(case, S):
    """dynamic_verified_lookup on the record upload equals the
    reference's mphf_probe_dynamic plus its verify and value gather
    (sharded_index.py:337-343) on keys, aliens and all-zero rows; the
    all-zero rows all get poly-A's answer, a hit exactly where it is a
    key of that shard."""
    k, image, polya = case
    lookup, n_levels = ref_build_lookup(image, S)
    q = _queries(image, np.random.default_rng(S))
    qt = torch.from_numpy(q.view(np.int32))
    zero = ~q.any(axis=1)
    zero_hits = 0
    for s in range(S):
        sh = [getattr(lookup, f)[s] for f in lookup._fields]
        slot = np.asarray(ref_probe_dynamic(jnp.asarray(q), *map(
            jnp.asarray, sh[:6]), n_levels))
        safe = np.maximum(slot, 0)
        ok = (slot >= 0) & np.all(sh[6][safe] == q, axis=1)
        want = np.where(ok[:, None], sh[7][safe], -1)
        port = si.upload_lookup(lookup, s, "cpu")
        got = dynamic_verified_lookup(qt, port, n_levels)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        zres = want[zero]
        assert (zres == zres[0]).all()
        zero_hits += int(zres[0, 0] >= 0)
    assert zero_hits == (1 if polya else 0)


@pytest.mark.parametrize("mode", ["cuckoo", "mphf"])
def test_stats_counts_with_zero_kmers_match_reference(case, mode):
    """batch_stats (stats_counts on the CPU) on the paired upload equals
    the reference's _stats_impl on reads that hold all-zero k-mers (poly-A
    reads and zero tails), aliens and exact windows."""
    k, image, polya = case
    rng = np.random.default_rng(k)
    Lk = L[k]
    reads = [("A", np.zeros(Lk, np.uint8)), ("A2", np.zeros(k + 3, np.uint8))]
    seq_of = image.seq_pool
    for i in range(40):
        st = int(rng.integers(0, len(seq_of) - Lk))
        w = seq_of[st:st + Lk].copy()
        if i % 3 == 1:
            w = w[::-1].copy()
        elif i % 3 == 2:
            w = rng.integers(0, 4, Lk).astype(np.uint8)
        reads.append((f"r{i}", w))
    codes, lens = make_batch(reads, len(reads) + 3, Lk)
    cfg = AlignerConfig(k=k, max_read_len=Lk, seed_index=mode,
                        pool_overlap=False)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    packed = ref_mk.pack_reads_host(codes)
    want = ref_batch_stats(meta, dev_np, packed, lens)
    idx, pmeta = port_index(dev_np, meta)
    got = stats.batch_stats(pmeta, idx,
                            torch.from_numpy(packed.view(np.int32)),
                            torch.from_numpy(lens))
    assert got.as_dict() == want.as_dict()
    assert 0 < got.n_seed_hits < got.n_positions
