"""PyTorch port vs the JAX reference: the k-mer-partitioned index mode.

The sharded lookup (per-shard sub-MPHFs), the dynamic-level MPHF probe,
the routed seed tables (owner hash, stable bucketing into fixed-capacity
buffers, the -3 lanes of routing overflow), the graph partition
(build_sharded_graph) and the KmerPartitionedAligner with a replicated
graph and with a sharded one (shard_graph=True: the routed walk of
parallel/graph_walk.py), at S = 1, 2, 4 and 8 shards: the reference on its
virtual 8-device CPU mesh, the port on a loopback mesh of S shards on the
CPU.  Equal with tolerance 0, dtypes and shapes included; the serving
aligner's emitted bytes (single-end, paired, `count`) equal."""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.ops.map_kernel import device_index_from_image
from pseudoaligner_tpu.ops.mphf_lookup import (
    mphf_probe_dynamic as ref_probe_dynamic,
)
from pseudoaligner_tpu.parallel.mesh import make_mesh as ref_make_mesh
from pseudoaligner_tpu.parallel.sharded_index import (
    KmerPartitionedAligner as RefKPart,
    KPartMeta as RefKPartMeta,
    ShardedLookup as RefLookup,
    _routed_seed_tables as ref_routed,
    build_sharded_graph as ref_build_graph,
    build_sharded_lookup as ref_build_lookup,
)
from pseudoaligner_tpu.singlecell import count_single_cell as ref_count
from pseudoaligner_torch.config import AlignerConfig as PortConfig
from pseudoaligner_torch.ops import map_kernel as mk
from pseudoaligner_torch.ops.mphf_lookup import (
    dynamic_verified_lookup,
    mphf_probe_dynamic,
)
from pseudoaligner_torch.parallel import sharded_index as si
from pseudoaligner_torch.parallel.mesh import make_mesh
from pseudoaligner_torch.singlecell import count_single_cell

from .torch_helpers import (
    _fuzz_reads,
    assert_results_equal,
    build,
    family_transcripts,
    image_from_reference,
    write_fastq,
)

SHAPES = {
    "full": dict(distinct_cap=0, max_nodes=64),
    "compact": dict(distinct_cap=3, max_walk_iters=3, max_left_iters=2,
                    max_nodes=9),
}
B, L = 64, 64


@pytest.fixture(scope="module")
def data():
    """Isoform families (short unitigs, many classes) and a batch of fuzz
    reads (exact, SNP-bearing, reversed and random windows) with short
    reads, empty rows and left-extension reads (a SNP at base 13 puts the
    first hit past the left gate, so the left loop walks back):
    (reference image, port image, codes, lens)."""
    rng = np.random.default_rng(4040)
    seqs, names, gmap = family_transcripts(rng, n_genes=4, n_iso=5)
    image = build(seqs, names, gmap, k=20)
    reads = _fuzz_reads(rng, seqs, k=20, n=B - 4, L=L)
    codes = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for j, (_, c) in enumerate(reads):
        if j % 5 == 0:
            c = c[:24]  # short reads: most positions invalid
        codes[j, : len(c)] = c
        lens[j] = len(c)
    for j in range(1, B - 4, 6):
        t = seqs[j % len(seqs)]
        s0 = int(rng.integers(0, len(t) - L))
        codes[j] = t[s0:s0 + L]
        codes[j, 13] = (codes[j, 13] + 1) % 4
        lens[j] = L
    return image, image_from_reference(image), codes, lens


def _cfg(shape, **more):
    return dict(k=20, batch_size=B, max_read_len=L, lazy_seeds=False,
                **SHAPES[shape], **more)


def _ref_config(kw):
    """The reference's AlignerConfig of the shared fields `kw`, without
    its left-loop lane compaction: reads beyond that buffer come out -3
    there and mapped in the port, so the arrays would differ."""
    return AlignerConfig(**kw, left_compact=0.0)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_build_sharded_lookup_matches_reference(data, S):
    image, pimage, _, _ = data
    want, nl_want = ref_build_lookup(image, S)
    got, nl_got = si.build_sharded_lookup(pimage, S)
    assert nl_got == nl_want
    for f in want._fields:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f


def _bases(words) -> np.ndarray:
    """2-bit base codes of flat uint32 words (base i at bits 2*(i%16) of
    word i/16)."""
    w = np.asarray(words, dtype=np.uint32).reshape(-1)
    sh = (2 * np.arange(16)).astype(np.uint32)
    return ((w[:, None] >> sh) & 3).reshape(-1).astype(np.uint8)


def _ref_flat_words(rows, stride: int) -> np.ndarray:
    """The reference's [R, 8] pool rows as flat words: rows overlap and
    start every stride // 16 words when stride > 0."""
    if not stride:
        return rows.reshape(-1)
    sw = stride // 16
    flat = np.zeros((rows.shape[0] - 1) * sw + 8, dtype=np.uint32)
    for r in range(rows.shape[0]):
        flat[r * sw:r * sw + 8] = rows[r]
    return flat


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_build_sharded_graph_matches_reference(data, S):
    """Node rows equal the reference's (start rebased to the block pool,
    global edge ids); each block's flat pool holds the reference block
    pool's bases, base for base over the block's padded span."""
    image, pimage, _, _ = data
    _, meta = device_index_from_image(image, _ref_config(_cfg("full")))
    _, pmeta = mk.device_index_from_image(pimage,
                                          PortConfig(**_cfg("full")))
    assert pmeta.pool_pad == meta.pool_pad
    want, nb_want = ref_build_graph(image, meta, S)
    got, nb = si.build_sharded_graph(pimage, pmeta, S)
    assert nb == nb_want == -(-image.n_nodes // S)
    rows = np.asarray(want.node_rows)
    assert got.node_rows.dtype == rows.dtype == np.int32
    assert np.array_equal(got.node_rows, rows)
    pad = meta.pool_pad
    for s in range(S):
        lo, hi = s * nb, min(image.n_nodes, (s + 1) * nb)
        span = 0
        if lo < hi:
            span = int(image.node_start[hi - 1] + image.node_len[hi - 1]
                       - image.node_start[lo])
        n = pad + span + pad
        ref = _bases(_ref_flat_words(np.asarray(want.pools[s]),
                                     meta.pool_stride))[:n]
        port = _bases(got.pools[s])[:n]
        assert got.pools.dtype == np.uint32
        assert np.array_equal(port, ref), s
        assert not port[:pad].any() and not port[pad + span:].any()
        if lo < hi:
            seq = np.asarray(image.seq_pool)[image.node_start[lo]:
                                             image.node_start[lo] + span]
            assert np.array_equal(port[pad:pad + span], seq)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_mphf_probe_dynamic_matches_reference(data, S):
    """Every shard's sub-MPHF probed with every key of the index plus
    alien k-mers (false positives the verify must reject): the slots equal
    the reference's, and the verified lookup equals the reference's verify
    and gather (sharded_index.py:337-343)."""
    image, pimage, _, _ = data
    lookup, n_levels = ref_build_lookup(image, S)
    rng = np.random.default_rng(S)
    aliens = rng.integers(0, 2**32, (300, image.kmer_keys.shape[1]),
                          dtype=np.uint64).astype(np.uint32)
    aliens[:, -1] &= np.uint32((1 << (2 * 20 - 32)) - 1)  # k = 20 k-mers
    q = np.concatenate([image.kmer_keys, aliens])
    qt = torch.from_numpy(q.view(np.int32))
    n_hit = n_fp = 0
    for s in range(S):
        sh = [getattr(lookup, f)[s] for f in lookup._fields]
        want = np.asarray(ref_probe_dynamic(jnp.asarray(q), *map(
            jnp.asarray, sh[:6]), n_levels))
        port = si.upload_lookup(lookup, s, "cpu")
        got = mphf_probe_dynamic(qt, *port[:6], n_levels)
        assert got.dtype == torch.int32 and want.dtype == np.int32
        assert np.array_equal(got.numpy(), want)
        # the reference's verify and value gather
        safe = np.maximum(want, 0)
        ok = (want >= 0) & np.all(sh[6][safe] == q, axis=1)
        vals = np.where(ok[:, None], sh[7][safe], -1)
        res = dynamic_verified_lookup(qt, port, n_levels)
        assert res.dtype == torch.int32 and res.shape == (len(q), 2)
        assert np.array_equal(res.numpy(), vals)
        n_hit += int(ok.sum())
        n_fp += int(((want >= 0) & ~ok)[len(image.kmer_keys):].sum())
    assert n_hit == len(image.kmer_keys)  # every key found in its shard
    assert n_fp > 0  # aliens landed on set bits


def _ref_routed(meta, kmeta, lookup, codes, lens, S):
    """The reference's _routed_seed_tables under shard_map over S
    devices -> numpy (seed_node, seed_off, overflow per shard, dropped)."""
    def local(lk, reads, ln):
        node, off, over, drop = ref_routed(meta, kmeta, lk, reads, ln,
                                           "reads")
        return node, off, over[None], drop

    fn = jax.jit(jax.shard_map(
        local, mesh=ref_make_mesh(S),
        in_specs=(RefLookup(*[JP("reads")] * 8), JP("reads"), JP("reads")),
        out_specs=(JP("reads"),) * 4, check_vma=False))
    out = fn(RefLookup(*map(jnp.asarray, lookup)),
             jnp.asarray(codes, jnp.int32), jnp.asarray(lens, jnp.int32))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("cap", [None, 8])
def test_routed_seed_tables_match_reference(data, S, cap):
    """Seed tables, per-shard overflow and dropped reads, at the default
    capacity and at a capacity of 8 that forces overflow (which queries
    drop follows the stable order)."""
    image, pimage, codes, lens = data
    if cap == 8:
        codes = codes.copy()
        lens = lens.copy()
        codes[-8:] = 1  # poly-C reads: every query of theirs to one owner
        lens[-8:] = L
    cfg = _ref_config(_cfg("full"))
    _, meta = device_index_from_image(image, cfg)
    lookup, n_levels = ref_build_lookup(image, S)
    if cap is None:
        cap = max(64, int(4.0 * (B // S) * meta.n_positions / S))
        cap = (cap + 7) // 8 * 8
    want = _ref_routed(meta, RefKPartMeta(S, n_levels, cap), lookup, codes,
                       lens, S)

    _, pmeta = mk.device_index_from_image(pimage, PortConfig(**_cfg("full")))
    mesh = make_mesh(S, loopback=True, device="cpu")
    b = B // S
    packed = [mk.pack_reads_device(torch.from_numpy(
        codes[r * b:(r + 1) * b].astype(np.int32))) for r in range(S)]
    ln = [torch.from_numpy(lens[r * b:(r + 1) * b]) for r in range(S)]
    got = si._routed_seed_tables(
        pmeta, si.KPartMeta(S, n_levels, cap),
        [si.upload_lookup(lookup, r, "cpu") for r in range(S)], packed, ln,
        mesh)
    node = torch.cat([g[0] for g in got]).numpy()
    off = torch.cat([g[1] for g in got]).numpy()
    over = torch.stack([g[2] for g in got]).numpy()
    drop = torch.cat([g[3] for g in got]).numpy()
    assert got[0][2].dtype == torch.int32 and got[0][2].shape == ()
    for a, w in ((node, want[0]), (off, want[1]), (over, want[2]),
                 (drop, want[3])):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert np.array_equal(a, w)
    if cap == 8:
        assert over.sum() > 0 and drop.any() and not drop.all()
    else:
        assert over.sum() == 0
    assert (node >= 0).any()


@pytest.mark.parametrize("shape,S,shard_graph", [
    pytest.param(shape, S, sg, id=f"{shape}-{S}" + ("-graph" if sg else ""))
    for sg in (False, True) for S in (1, 2, 4, 8) for shape in SHAPES])
def test_kpart_matches_reference(data, S, shape, shard_graph):
    """Every MapResult field and the counts, full-output and compact
    shapes, short reads included; with the graph replicated and sharded.
    The graph-sharded full output intersects the pushed class ids (its
    replicated node_row is a placeholder): ec_bits and counts equal."""
    image, pimage, codes, lens = data
    kw = _cfg(shape)
    want, want_counts = RefKPart(
        image, _ref_config(kw), ref_make_mesh(S),
        shard_graph=shard_graph).map_batch(codes, lens)
    kp = si.KmerPartitionedAligner(pimage, PortConfig(**kw),
                                   make_mesh(S, loopback=True, device="cpu"),
                                   shard_graph=shard_graph)
    got, counts = kp.map_batch(codes, lens)
    assert_results_equal(want, got, f"kpart S={S} {shape} {shard_graph}")
    want_counts = np.asarray(want_counts)
    assert counts.dtype == torch.int32 and counts.shape == want_counts.shape
    assert np.array_equal(counts.numpy(), want_counts)
    assert got.mapped.any()
    if shape == "full":
        assert want_counts.sum() > 0 and np.asarray(want.ec_bits).any()
    if shard_graph:
        st = kp.walk_stats
        assert st["left_iters"] > 0 and st["forward_iters"] > 0
        assert st["all_to_alls"] == 2 * st["fetches"] == 2 * (
            2 * st["left_iters"] + st["forward_iters"])
        if shape == "compact":
            # the serving caps (2 left, 3 forward): at most 7 fetches and
            # 5 liveness syncs per walk
            assert st["fetches"] <= 7 and st["syncs"] <= 5
    else:
        assert kp.graphs is None and kp.kmeta.node_block == 0


@pytest.mark.parametrize("shape", list(SHAPES))
def test_kpart_graph_sharded_with_empty_shards(shape):
    """Fewer nodes than shards (N < S): the shards past the last node hold
    a zero block and serve no request; results equal the reference's."""
    rng = np.random.default_rng(515)
    seqs = [rng.integers(0, 4, 300).astype(np.uint8) for _ in range(2)]
    names = ["t0", "t1"]
    image = build(seqs, names, {"t0": "g0", "t1": "g1"}, k=20)
    S = 8
    assert image.n_nodes < S
    reads = _fuzz_reads(rng, seqs, k=20, n=B, L=L)
    codes = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for j, (_, c) in enumerate(reads):
        codes[j, : len(c)] = c
        lens[j] = len(c)
    kw = _cfg(shape)
    want, want_counts = RefKPart(image, _ref_config(kw),
                                 ref_make_mesh(S),
                                 shard_graph=True).map_batch(codes, lens)
    kp = si.KmerPartitionedAligner(
        image_from_reference(image), PortConfig(**kw),
        make_mesh(S, loopback=True, device="cpu"), shard_graph=True)
    assert kp.kmeta.node_block == 1
    assert not kp.graphs[-1].node_rows.any()  # an empty shard
    got, counts = kp.map_batch(codes, lens)
    assert_results_equal(want, got, f"kpart N<S {shape}")
    assert np.array_equal(counts.numpy(), np.asarray(want_counts))
    assert got.mapped.any()


def test_kpart_routing_overflow_lanes_match_reference(data):
    """A slack that overflows the buffers: in the compact shape the
    dropped reads carry -3 in the last ec_distinct column exactly where
    the reference puts it, and their records re-map exactly; the full
    output raises."""
    _routing_overflow_case(data, shard_graph=False)


def test_kpart_graph_sharded_routing_overflow_lanes_match_reference(data):
    """The same with the graph sharded: the -3 lanes of routing overflow
    ride the graph-sharded walk's compact output too."""
    _routing_overflow_case(data, shard_graph=True)


def _routing_overflow_case(data, shard_graph):
    image, pimage, codes, lens = data
    codes = codes.copy()
    lens = lens.copy()
    codes[B // 2:] = 1
    lens[B // 2:] = L
    kw = _cfg("compact")
    ref = RefKPart(image, _ref_config(kw), ref_make_mesh(8), slack=0.05,
                   shard_graph=shard_graph)
    kp = si.KmerPartitionedAligner(
        pimage, PortConfig(**kw), make_mesh(8, loopback=True, device="cpu"),
        slack=0.05, shard_graph=shard_graph)
    assert kp.kmeta.cap == ref.kmeta.cap
    want, _ = ref.map_batch(codes, lens)
    got, _ = kp.map_batch(codes, lens)
    assert_results_equal(want, got, "kpart overflow")
    last = got.ec_distinct[:, -1].numpy()
    assert (last[B // 2:] == -3).any()
    srv = kp.serving_aligner()
    base = srv.__class__(pimage, PortConfig(**kw), device="cpu")
    from pseudoaligner_torch.io.fastq import ReadBatch

    batch = ReadBatch(codes=codes, lens=lens,
                      ids=[f"r{i}" for i in range(B)])
    assert [r.format_reference_style() for r in srv.records_from_result(
        srv.map_batch_device(codes, lens), batch)] == [
        r.format_reference_style() for r in base.records_from_result(
            base.map_batch_device(codes, lens), batch)]
    kp_full = si.KmerPartitionedAligner(
        pimage, PortConfig(**_cfg("full")),
        make_mesh(8, loopback=True, device="cpu"), slack=0.05,
        shard_graph=shard_graph)
    with pytest.raises(RuntimeError, match="routing overflow"):
        kp_full.map_batch(codes, lens)


@pytest.mark.parametrize("shard_graph", [False, True])
def test_kpart_codes_cross_the_link_as_uint8(data, shard_graph):
    """map_batch on uint8, int32 and int64 code arrays: the step receives
    each shard's codes as uint8 (one byte a base) and packs them from that
    width, and all three give the reference's MapResult and counts."""
    image, pimage, codes, lens = data
    kw = _cfg("compact")
    want, want_counts = RefKPart(
        image, _ref_config(kw), ref_make_mesh(2),
        shard_graph=shard_graph).map_batch(codes, lens)
    kp = si.KmerPartitionedAligner(pimage, PortConfig(**kw),
                                   make_mesh(2, loopback=True, device="cpu"),
                                   shard_graph=shard_graph)
    seen = []
    step = kp._step

    def spy(idx, lookups, codes_, lens_, *rest):
        seen.append([(c.dtype, tuple(c.shape)) for c in codes_])
        return step(idx, lookups, codes_, lens_, *rest)

    kp._step = spy
    for dt in (np.uint8, np.int32, np.int64):
        got, counts = kp.map_batch(codes.astype(dt), lens)
        assert_results_equal(want, got, f"kpart codes {np.dtype(dt).name}")
        assert np.array_equal(counts.numpy(), np.asarray(want_counts))
    assert seen == [[(torch.uint8, (B // 2, L))] * 2] * 3
    link, _ = kp.link_batch(codes.astype(np.int64), lens)
    assert sum(c.numel() * c.element_size() for c in link) == B * L


def test_kpart_short_reads_route_nowhere(data):
    """24-base reads at a width of 64: their invalid positions route to no
    shard, so 8 shards at the default slack do not overflow."""
    _, pimage, codes, lens = data
    short = np.zeros_like(codes)
    short[:, :24] = codes[:, :24]
    slens = np.minimum(lens, 24)
    kp = si.KmerPartitionedAligner(
        pimage, PortConfig(**_cfg("full")),
        make_mesh(8, loopback=True, device="cpu"))
    res, _ = kp.map_batch(short, slens)  # raises on routing overflow
    assert res.mapped.any()


def test_kpart_serving_surface_matches_reference(data, tmp_path):
    """serving_aligner() at S = 2: single-end and paired emitted bytes
    and `count`'s output files equal the reference's kpart serving
    aligner's, under a serving config whose caps flag reads for the exact
    re-map."""
    _serving_surface_case(data, tmp_path, shard_graph=False)


def test_kpart_graph_sharded_serving_surface_matches_reference(data,
                                                               tmp_path):
    """The same with the graph sharded (shard_graph=True)."""
    _serving_surface_case(data, tmp_path, shard_graph=True)


def _serving_surface_case(data, tmp_path, shard_graph):
    image, pimage, _, _ = data
    rng = np.random.default_rng(77)
    seqs, _, _ = family_transcripts(np.random.default_rng(4040), n_genes=4,
                                    n_iso=5)
    reads = _fuzz_reads(rng, seqs, k=20, n=300, L=60)
    fq, m1, m2 = (str(tmp_path / f) for f in ("r.fq", "m1.fq", "m2.fq"))
    write_fastq(fq, reads[:150])
    write_fastq(m1, [(f"p{i}", w) for i, (_, w) in enumerate(reads[:150])])
    write_fastq(m2, [(f"p{i}", w) for i, (_, w) in enumerate(reads[150:])])
    c1 = str(tmp_path / "c1.fq")
    with open(c1, "w") as f:
        for i in range(150):
            bc = "ACGTACGTACGTACG" + "ACGT"[i % 4]
            umi = "".join("ACGT"[int(x)] for x in rng.integers(0, 4, 12))
            f.write(f"@p{i}\n{bc}{umi}\n+\n{'I' * 28}\n")
    kw = dict(k=20, batch_size=64, max_read_len=64, max_nodes=9,
              distinct_cap=3, max_walk_iters=3, max_left_iters=2,
              lazy_seeds=False)
    ref = RefKPart(image, _ref_config(kw), ref_make_mesh(2),
                   shard_graph=shard_graph).serving_aligner()
    srv = si.KmerPartitionedAligner(
        pimage, PortConfig(**kw), make_mesh(2, loopback=True, device="cpu"),
        shard_graph=shard_graph).serving_aligner()
    out = {}
    for tag, al in (("ref", ref), ("port", srv)):
        single, paired = io.BytesIO(), io.BytesIO()
        assert al.emit_fastq(fq, single)[0] == 150
        assert al.emit_fastq_paired(m1, m2, paired) == 150
        counter = ref_count if tag == "ref" else count_single_cell
        d = str(tmp_path / tag)
        counter(al, c1, m2).write(d)
        files = {}
        for name in ("barcodes.tsv", "ec.tsv", "matrix.mtx"):
            with open(os.path.join(d, name), "rb") as fh:
                files[name] = fh.read()
        out[tag] = (single.getvalue(), paired.getvalue(), files)
        al.close()
    assert out["port"] == out["ref"]
    assert out["port"][0].count(b"\n") == 150
    assert out["port"][2]["matrix.mtx"].count(b"\n") > 3


def test_shard_graph_is_not_ported(data):
    """shard_graph=True builds S blocks of ceil(N/S) node rows, one per
    shard, and leaves a placeholder node_row and pool in the replicated
    arrays; a mesh that is not a power of two is refused."""
    _, pimage, _, _ = data
    for S in (2, 4):
        kp = si.KmerPartitionedAligner(
            pimage, PortConfig(**_cfg("full")),
            make_mesh(S, loopback=True, device="cpu"), shard_graph=True)
        nb = -(-pimage.n_nodes // S)
        assert kp.kmeta.node_block == nb and len(kp.graphs) == S
        assert all(g.node_rows.shape == (nb, 12) for g in kp.graphs)
        assert kp.dev.node_row.shape == (1, 12)
        assert kp.dev.pool_rows.numel() == 8
    with pytest.raises(ValueError, match="power of two"):
        si.KmerPartitionedAligner(pimage, PortConfig(**_cfg("full")),
                                  make_mesh(3, loopback=True, device="cpu"))
