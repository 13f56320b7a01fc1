"""PyTorch port vs the JAX reference: the bucket1 and MPHF seed indexes
(`map --seed-index bucket1|mphf`) and `batch_stats`.

The probes, the next-hit table, every MapResult field, the seed statistics
and the CLI's stdout are compared exactly (integer outputs, tolerance 0).
As in tests/test_torch_walk.py the reference runs with left_compact=0.0
and bitset_tx_threshold=0 where MapResults are compared."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.dna import pack_kmers
from pseudoaligner_tpu.models.aligner import _MAP_STEP_JIT
from pseudoaligner_tpu.ops import map_kernel as ref_mk
from pseudoaligner_tpu.ops import mphf_lookup as ref_mphf
from pseudoaligner_tpu.ops.stats import batch_stats as ref_batch_stats
from pseudoaligner_tpu.serde import save_index
from pseudoaligner_torch.ops import map_kernel as mk
from pseudoaligner_torch.ops import mphf_lookup, stats
from pseudoaligner_torch.ops.hashing import hash_kmer_np

from .torch_helpers import (
    _fuzz_reads,
    assert_results_equal,
    build,
    family_transcripts,
    from_jax_device_index,
    make_batch,
    polyt_transcripts,
    port_index,
    write_fastq,
)

MODES = ("bucket1", "mphf")
K_L = {20: 64, 64: 96}
SERVING = dict(distinct_cap=3, max_walk_iters=3, max_left_iters=2,
               max_nodes=7)


@pytest.fixture(scope="module", params=[20, 64])
def case(request):
    """Random transcripts plus a poly-T one (the all-ones k-mer is an
    ordinary key of bucket1 and the MPHF at k = 64) and fuzz reads."""
    k = request.param
    rng = np.random.default_rng(700 + k)
    seqs, names, gmap = polyt_transcripts(rng)
    seqs2, _, _ = family_transcripts(rng, n_genes=2, n_iso=4)
    seqs += seqs2
    names += [f"f{i}" for i in range(len(seqs2))]
    gmap.update({f"f{i}": "FG" for i in range(len(seqs2))})
    image = build(seqs, names, gmap, k=k)
    reads = _fuzz_reads(rng, seqs, k=k, n=200, L=K_L[k] - 6)
    reads.append(("polyT", np.full(K_L[k] - 4, 3, np.uint8)))
    return k, image, reads


def _cfg(k, mode, **kw):
    return AlignerConfig(k=k, max_read_len=K_L[k], seed_index=mode,
                         pool_overlap=False, left_compact=0.0,
                         bitset_tx_threshold=0, **kw)


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_seed_tables_match_reference(case, mode, lazy):
    k, image, reads = case
    L = K_L[k]
    dev_np, meta = ref_mk.device_index_from_image(
        image, _cfg(k, mode, lazy_seeds=lazy))
    codes, lens = make_batch(reads, 224, L)
    ref = np.asarray(ref_mk._seed_tables(
        meta, dev_np, jnp.asarray(codes.astype(np.int32)),
        jnp.asarray(lens))[0])
    idx, pmeta = port_index(dev_np, meta)
    packed = torch.from_numpy(ref_mk.pack_reads_host(codes).view(np.int32))
    got = mk.seed_tables(pmeta, idx, packed, torch.from_numpy(lens))
    P = meta.n_positions
    assert (ref[:, :, 0] < P).any()
    # lazy seeds exist for bucket1 only: the MPHF probes every residue
    assert pmeta.lazy_seeds == (lazy and mode == "bucket1")
    assert (ref[:, 1::3, 0] < P).any() != pmeta.lazy_seeds
    if pmeta.lazy_seeds:
        # the reference's residue 1 and 2 rows hold nothing: the port's
        # lazy table has the residue-0 rows alone
        assert (ref[:, np.arange(P) % 3 != 0] == [P, -1, -1]).all()
        ref = ref[:, ::3]
    assert got.dtype == torch.int32
    assert got.shape == (len(lens), pmeta.nh3_rows, 3) == ref.shape
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode", MODES)
def test_probe_every_kmer(case, mode):
    """Every k-mer of the index and as many random ones, probed by both
    engines' probe of the mode; members resolve to their own payload."""
    k, image, _ = case
    dev_np, meta = ref_mk.device_index_from_image(image, _cfg(k, mode))
    keys = np.asarray(image.kmer_keys)
    noise = pack_kmers(np.random.default_rng(k).integers(
        0, 4, 4000).astype(np.uint8), k)
    queries = np.concatenate([keys, noise])
    if mode == "bucket1":
        rn, ro = ref_mk.bucket1_lookup(meta, dev_np, jnp.asarray(queries))
    else:
        rn, ro = ref_mphf.verified_lookup(
            jnp.asarray(queries), dev_np.mphf_bits, dev_np.mphf_ranks,
            meta.mphf, dev_np.kmer_keys, dev_np.kmer_node,
            dev_np.kmer_offset)
    idx, pmeta = port_index(dev_np, meta)
    pn, po = mk.seed_probe(pmeta, idx,
                           torch.from_numpy(queries.astype(np.int64)))
    assert pn.dtype == po.dtype == torch.int32
    assert np.array_equal(pn.numpy(), np.asarray(rn))
    assert np.array_equal(po.numpy(), np.asarray(ro))
    n = len(keys)
    assert np.array_equal(pn.numpy()[:n], image.kmer_node.astype(np.int32))
    assert np.array_equal(po.numpy()[:n], image.kmer_offset.astype(np.int32))
    if k == 64:  # the all-ones k-mer is a stored key, not a meta payload
        assert np.all(keys == np.uint32(0xFFFFFFFF), axis=1).sum() == 1
        assert pmeta.ones_node == -1


def test_mphf_probe_slots_match_reference(case):
    """The unverified level probe: the same slot (or -1) for members and
    aliens alike, false positives included; bit position 31 occurs."""
    k, image, _ = case
    m = image.mphf
    rng = np.random.default_rng(31)
    noise = pack_kmers(rng.integers(0, 4, 20000).astype(np.uint8), k)
    queries = np.concatenate([np.asarray(image.kmer_keys), noise])
    ref = np.asarray(ref_mphf.mphf_probe(
        jnp.asarray(queries), jnp.asarray(m.bits), jnp.asarray(m.ranks),
        ref_mphf.MphfMeta(*(tuple(int(x) for x in a) for a in (
            m.seeds, m.masks, m.word_offsets, m.key_offsets)))))
    pmeta = mphf_lookup.MphfMeta.of(m)
    got = mphf_lookup.mphf_probe(
        torch.from_numpy(queries.astype(np.int64)),
        torch.from_numpy(m.bits.view(np.int32)),
        torch.from_numpy(m.ranks.view(np.int32)), pmeta)
    assert np.array_equal(got.numpy(), ref.astype(np.int64))
    n = len(image.kmer_keys)
    assert sorted(got.numpy()[:n].tolist()) == list(range(n))
    h = hash_kmer_np(queries, pmeta.seeds[0]) & np.uint32(pmeta.masks[0])
    assert ((h & 31) == 31).any()


# the CLI's serving shape (cli.serving_config at L) and the uncapped
# full-output shape of the exact re-map
MAP_CONFIGS = {
    "serving": {20: SERVING, 64: dict(SERVING, max_walk_iters=4,
                                      max_nodes=8)},
    "full_uncapped": {20: dict(distinct_cap=0, max_nodes=128),
                      64: dict(distinct_cap=0, max_nodes=192)},
}


@pytest.mark.parametrize("name", list(MAP_CONFIGS))
@pytest.mark.parametrize("mode", MODES)
def test_map_batch_packed_matches_reference(case, mode, name):
    k, image, reads = case
    kw = MAP_CONFIGS[name][k]
    L = K_L[k]
    cfg = _cfg(k, mode, batch_size=len(reads), **kw)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    codes, lens = make_batch(reads, len(reads) + 9, L)  # padding rows
    packed = ref_mk.pack_reads_host(codes)
    ref = _MAP_STEP_JIT(meta, dev_np, packed, lens)
    idx, pmeta = port_index(dev_np, meta)
    got = mk.map_batch_packed(pmeta, idx,
                              torch.from_numpy(packed.view(np.int32)),
                              torch.from_numpy(lens))
    assert_results_equal(ref, got, f"{mode}/{name}")
    assert np.asarray(ref.mapped).any()


def test_map_batch_packed_own_index_matches_reference(case):
    """The port's own device_index_from_image (build_bucket1, the MPHF
    arrays) gives the reference's arrays and meta, mode by mode."""
    k, image, _ = case
    for mode in MODES:
        cfg = _cfg(k, mode)
        ref_dev, ref_meta = ref_mk.device_index_from_image(image, cfg)
        dev, meta = mk.device_index_from_image(image, cfg)
        for f in ("pool_rows", "node_row", "cuckoo", "cuckoo_vals",
                  "mphf_bits", "mphf_ranks", "kmer_keys", "kmer_node",
                  "kmer_offset"):
            a, b = np.asarray(getattr(ref_dev, f)), getattr(dev, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (mode, f)
        pm = from_jax_device_index(ref_dev, ref_meta)[1]
        assert meta == pm, mode


def _stats_batch(image, reads, k, L, rng):
    """Reads plus alien ones (random k-mers) so the MPHF returns false
    positives, and padding rows."""
    reads = reads + [(f"alien{i}", rng.integers(0, 4, L).astype(np.uint8))
                     for i in range(64)]
    codes, lens = make_batch(reads, len(reads) + 5, L)
    return codes, lens


@pytest.mark.parametrize("mode", ("cuckoo",) + MODES)
def test_batch_stats_matches_reference(case, mode):
    k, image, reads = case
    L = K_L[k]
    cfg = _cfg(k, mode)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    codes, lens = _stats_batch(image, reads, k, L,
                               np.random.default_rng(k + 1))
    packed = ref_mk.pack_reads_host(codes)
    want = ref_batch_stats(meta, dev_np, packed, lens)
    idx, pmeta = port_index(dev_np, meta)
    got = stats.batch_stats(pmeta, idx,
                            torch.from_numpy(packed.view(np.int32)),
                            torch.from_numpy(lens))
    assert got.as_dict() == want.as_dict()
    assert got.n_probe_false_positives > 0  # the verify path ran
    assert 0 < got.n_seed_hits < got.n_positions


def test_serving_upload_dummies(case):
    """A serving upload carries what its probe reads; the cuckoo and
    bucket1 ones drop the MPHF arrays (batch_stats then refuses them),
    the MPHF one carries no bucket rows."""
    k, image, reads = case
    L = K_L[k]
    codes, lens = make_batch(reads, 32, L)
    packed = torch.from_numpy(mk.pack_reads_host(codes).view(np.int32))
    lens = torch.from_numpy(lens)
    sizes = {}
    for mode in ("cuckoo",) + MODES:
        dev_np, meta = mk.device_index_from_image(image, _cfg(k, mode))
        full = mk.upload(dev_np, "cpu")
        serve = mk.upload(dev_np, "cpu", serving=meta)
        sizes[mode] = serve.nbytes()
        kept = ("pool_rows", "node_row", "cuckoo", "cuckoo_vals")
        if mode == "mphf":
            assert torch.equal(serve.kmer_keys, full.kmer_keys)
            assert serve.cuckoo.numel() == 4 * meta.kmer_words
            stats.batch_stats(meta, serve, packed, lens)
        else:
            assert serve.nbytes() == sum(getattr(full, n).numel() * 4
                                         for n in kept)
            with pytest.raises(ValueError, match="full DeviceIndex"):
                stats.batch_stats(meta, serve, packed, lens)
            stats.batch_stats(meta, full, packed, lens)
        assert full.nbytes() >= serve.nbytes()
    assert sizes["mphf"] < sizes["cuckoo"]


@pytest.mark.parametrize("mode", MODES)
def test_cli_map_seed_index_matches_reference(tmp_path, capsysbinary, mode):
    """`map --seed-index MODE`: the port's stdout equals the JAX CLI's,
    and both equal the cuckoo run's (records do not depend on the seed
    index)."""
    from pseudoaligner_torch import cli as port_cli
    from pseudoaligner_tpu import cli as ref_cli

    rng = np.random.default_rng(91)
    seqs, names, gmap = family_transcripts(rng, n_genes=3, n_iso=5)
    image = build(seqs, names, gmap, k=20)
    reads = _fuzz_reads(rng, seqs, k=20, n=300, L=80)
    fq, idx = str(tmp_path / "r.fq"), str(tmp_path / "i.bin")
    write_fastq(fq, reads)
    save_index(image, idx)
    base = ["map", "-i", idx, fq, "--batch-size", "128",
            "--max-read-len", "72"]
    outs = {}
    for tag, main, more in (
            ("ref", ref_cli.main, ["--seed-index", mode]),
            ("port", port_cli.main, ["--seed-index", mode, "--device", "cpu"]),
            ("port_cuckoo", port_cli.main, ["--device", "cpu"])):
        assert main(base + more + ["-o", str(tmp_path / tag)]) == 0, tag
        outs[tag] = capsysbinary.readouterr().out
    assert outs["port"] == outs["ref"] == outs["port_cuckoo"]
    assert outs["port"].count(b"\n") == len(reads)
    assert any(not line.endswith(b"[], 0)")
               for line in outs["port"].splitlines())


def test_pseudoaligner_serves_every_seed_index(case, tmp_path):
    """The serving surface under each seed index emits the same records.
    Under the MPHF the flagged reads also take the exact device re-map
    (no native host mapper), which keeps the serving seed index."""
    from pseudoaligner_torch.models.aligner import Pseudoaligner

    k, image, reads = case
    fq = str(tmp_path / "r.fq")
    write_fastq(fq, reads)
    outs = {}
    for mode in ("cuckoo",) + MODES + ("mphf_device_remap",):
        # caps that bite: every walk past one step is flagged for re-map
        cfg = AlignerConfig(k=k, batch_size=256, max_read_len=K_L[k],
                            seed_index=mode.split("_")[0], distinct_cap=3,
                            max_walk_iters=1, max_left_iters=1, max_nodes=3)
        al = Pseudoaligner(image, cfg, device="cpu")
        if mode == "mphf_device_remap":
            al._host_mapper = lambda: None
        buf = io.BytesIO()
        try:
            n, _ = al.emit_fastq(fq, buf)
            if mode == "mphf_device_remap":
                assert al._remap_meta.seed_index == "mphf"
                assert al._remap_meta.distinct_cap == 0
        finally:
            al.close()
        assert n == len(reads)
        outs[mode] = buf.getvalue()
    assert len(set(outs.values())) == 1
