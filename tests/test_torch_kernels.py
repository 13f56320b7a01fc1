"""The CUDA kernels (K1 seed and its next_hit entry, K2 walk, K3 stats,
K4 bitset EC intersection and its entry from class ids, K5 packed-upload
unpack, K6 read pack, K7 route and unscatter, K8 dynamic MPHF probe, K9
transcript counts, K10 the graph-sharded walk's steps, K11 its routed
fetch) against their plain PyTorch versions, under each seed index
(cuckoo, bucket1, MPHF).

The card tests carry the `gpu` marker and skip without a CUDA device;
chip_smoke.py runs the same comparison at full size on the card.  The edge
cases hold K1's read tiles and K2's blocks at batch sizes around them,
read widths with P % 3 != 0, every W (k = 15, 20, 33, 40, 64) and the full
output at max_nodes 192, under each seed index.  The CPU
tests pin the dispatch rule: CPU tensors take the plain passes and never
reach a kernel wrapper, and the wrappers refuse CPU tensors.

This file imports only the port (no jax, no pseudoaligner_tpu), so it
also runs where jax is absent (the GPU machine), without the repo's
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from pseudoaligner_torch.config import AlignerConfig
from pseudoaligner_torch.index.builder import build_index
from pseudoaligner_torch.ops import kernels
from pseudoaligner_torch.ops import map_kernel as mk
from pseudoaligner_torch.ops import stats

SHAPES = {
    "serving": (20, 64, dict(distinct_cap=3, max_walk_iters=3,
                             max_left_iters=2, max_nodes=7)),
    "compact_uncapped": (20, 64, dict(distinct_cap=2, max_walk_iters=0,
                                      max_left_iters=0, max_nodes=64)),
    "full_eager_seeds": (20, 64, dict(distinct_cap=0, max_nodes=128,
                                      lazy_seeds=False)),
    "k64": (64, 96, dict(distinct_cap=3, max_walk_iters=4,
                         max_left_iters=2, max_nodes=8)),
    "bucket1_serving": (20, 64, dict(distinct_cap=3, max_walk_iters=3,
                                     max_left_iters=2, max_nodes=7,
                                     seed_index="bucket1")),
    "bucket1_k64": (64, 96, dict(distinct_cap=3, max_walk_iters=4,
                                 max_left_iters=2, max_nodes=8,
                                 seed_index="bucket1")),
    "mphf_serving": (20, 64, dict(distinct_cap=3, max_walk_iters=3,
                                  max_left_iters=2, max_nodes=7,
                                  seed_index="mphf")),
    "mphf_full_k64": (64, 96, dict(distinct_cap=0, max_nodes=192,
                                   seed_index="mphf")),
}


def _data(rng, k, L):
    """Random transcripts, isoforms cut by deletions (shared stretches,
    short unitigs), a poly-T transcript (the all-ones k-mer at k = 64),
    and reads: exact, SNP-bearing and reversed windows, poly-A, random,
    exactly-k and shorter-than-k."""
    seqs = [rng.integers(0, 4, int(rng.integers(200, 600))).astype(np.uint8)
            for _ in range(12)]
    for s in seqs[:6]:
        for _ in range(3):
            a = int(rng.integers(60, 140))
            seqs.append(np.concatenate([s[:a], s[a + int(rng.integers(15, 60)):]]))
    seqs.append(np.full(160, 3, np.uint8))
    names = [f"t{i}" for i in range(len(seqs))]
    image = build_index(seqs, names, {n: f"g{i % 5}" for i, n in
                                      enumerate(names)}, k=k)
    reads = []
    for i in range(600):
        s = seqs[int(rng.integers(len(seqs)))]
        n = min(len(s), int(rng.integers(k - 5, L + 1)))
        st = int(rng.integers(0, len(s) - n + 1))
        w = s[st : st + n].copy()
        kind = i % 6
        if kind == 1:
            for p in rng.integers(0, n, int(rng.integers(1, 5))):
                w[p] = (w[p] + 1) % 4
        elif kind == 2:
            w = w[::-1].copy()
        elif kind == 3:
            w = rng.integers(0, 4, n).astype(np.uint8)
        elif kind == 4:
            w[:] = 0
        reads.append(w)
    return image, reads


def _case(k, L, kw, device, serving=True):
    """(meta, index, packed reads, lens) on `device`: the index as the
    serving surface uploads it, or whole (serving=False, as batch_stats
    needs it)."""
    image, reads = _data(np.random.default_rng(k + L), k, L)
    cfg = AlignerConfig(k=k, max_read_len=L, **kw)
    dev_np, meta = mk.device_index_from_image(image, cfg)
    for i in range(0, 64, 4):  # alien reads: MPHF false positives
        reads.append(np.random.default_rng(i).integers(0, 4, L).astype(
            np.uint8))
    codes = np.zeros((len(reads) + 7, L), np.uint8)  # padding rows
    lens = np.zeros(len(codes), np.int32)
    for j, w in enumerate(reads):
        codes[j, : len(w)] = w
        lens[j] = len(w)
    packed = torch.from_numpy(mk.pack_reads_host(codes).view(np.int32))
    idx = mk.upload(dev_np, device, serving=meta if serving else None)
    return meta, idx, packed.to(device), torch.from_numpy(lens).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernels_match_plain_on_cuda(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    meta, idx, packed, lens = _case(*SHAPES[name], "cuda")
    nh3 = kernels.seed_tables_cuda(meta, idx, packed, lens)
    assert torch.equal(nh3, mk.seed_tables(meta, idx, packed, lens))
    got = kernels.walk_cuda(meta, idx, packed, lens, nh3)
    want = mk.walk(meta, idx, packed, lens, nh3)
    torch.cuda.synchronize()
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f


SERVING = SHAPES["serving"][2]
# (k, L, config, rows of the _case batch): batch sizes around K1's tiles
# (12 to 32 reads) and K2's block of 128; L with P % 3 != 0 and L not a
# multiple of 16; W = 1, 2, 3, 4 (k = 64: the all-ones k-mer); reads
# exactly k long (L = k) and shorter (every _data batch has them); the full
# output at max_nodes 192; long reads, whose probes stride over K1's block
EDGES = {
    "B0": (20, 64, SERVING, slice(0, 0)),
    "B1": (20, 64, SERVING, slice(0, 1)),
    "B33": (20, 64, SERVING, slice(0, 33)),
    "B129_eager": (20, 64, SHAPES["full_eager_seeds"][2], slice(0, 129)),
    "L60_P41": (20, 60, SERVING, None),
    "L62_P43": (20, 62, SERVING, None),
    "k15_W1": (15, 40, SERVING, None),
    "k33_W3": (33, 50, SERVING, None),
    "k40_W3": (40, 77, SERVING, None),
    "k64_L64": (64, 64, SERVING, None),
    "k64_eager": (64, 96, dict(SERVING, lazy_seeds=False), None),
    "full_M192": (20, 64, dict(distinct_cap=0, max_nodes=192,
                               lazy_seeds=False), None),
    "L300_eager": (20, 300, dict(SERVING, lazy_seeds=False), None),
}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["cuckoo", "bucket1", "mphf"])
@pytest.mark.parametrize("name", list(EDGES))
def test_kernel_edges_match_plain_on_cuda(name, mode):
    """K1 and K2 against the plain passes at the edges of their tiles and
    templates, in the case's shape and in the uncapped full output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k, L, kw, rows = EDGES[name]
    meta, idx, packed, lens = _case(k, L, dict(kw, seed_index=mode), "cuda")
    if rows is not None:
        packed, lens = packed[rows].contiguous(), lens[rows].contiguous()
    nh3 = kernels.seed_tables_cuda(meta, idx, packed, lens)
    assert torch.equal(nh3, mk.seed_tables(meta, idx, packed, lens))
    full = dataclasses.replace(meta, distinct_cap=0, max_walk_iters=0,
                               max_left_iters=0,
                               max_nodes=max(meta.max_nodes, 2 * L))
    for m in (meta, full):
        got = kernels.walk_cuda(m, idx, packed, lens, nh3)
        want = mk.walk(m, idx, packed, lens, nh3)
        torch.cuda.synchronize()
        for f in want._fields:
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert torch.equal(a, b), f


@pytest.mark.gpu
@pytest.mark.parametrize("B,P", [(0, 41), (1, 41), (37, 41), (70, 45),
                                 (33, 1), (5, 2), (40, 300)])
def test_next_hit_edges_match_plain_on_cuda(B, P):
    """K1's next_hit entry on seed tables with empty rows (no valid seed),
    lens from 0 past L, B around the tile, P from 1 to 300."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(B * 1000 + P)
    node = rng.integers(0, 50, (B, P)).astype(np.int32)
    node[rng.random((B, P)) < 0.5] = -1
    node[::3] = -1  # rows with no valid seed
    off = rng.integers(0, 9, (B, P)).astype(np.int32)
    lens = rng.integers(0, P + 25, B).astype(np.int32)
    args = [torch.from_numpy(a).to("cuda") for a in (node, off, lens)]
    got = kernels.next_hit_cuda(*args, 20)
    want = mk.next_hit_table(*args, 20, P)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k,L", [(20, 64), (64, 96)])
def test_stats_kernel_matches_plain_on_cuda(k, L):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    meta, idx, packed, lens = _case(k, L, dict(seed_index="cuckoo"), "cuda",
                                    serving=False)
    got = kernels.stats_cuda(meta, idx, packed, lens)
    want = stats.stats_counts(meta, idx, packed, lens)
    torch.cuda.synchronize()
    assert got.tolist() == want.tolist()
    assert got[2] > 0  # false positives: the verify path ran


# key words W -> (k, L) of the MPHF record tests: 16-byte records at W = 1
# (4 bytes of padding) and W = 2, 32-byte ones at W = 3 and 4
RECORD_KL = {1: (15, 40), 2: (20, 64), 3: (33, 50), 4: (64, 96)}


@pytest.mark.gpu
@pytest.mark.parametrize("W", sorted(RECORD_KL))
def test_mphf_record_seed_and_seek_match_plain_on_cuda(W):
    """K1 under the MPHF on the record layout, every position probed, and
    with lazy seeds forced on, K1's residue-0 probes and K2's lazy seek
    through the same record verify, against the plain passes, tolerance
    0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k, L = RECORD_KL[W]
    meta, idx, packed, lens = _case(k, L, dict(SERVING, seed_index="mphf"),
                                    "cuda")
    assert meta.kmer_words == W and not meta.lazy_seeds
    assert idx.kmer_records.shape[1] == mk.record_words(W)
    lazy = dataclasses.replace(meta, lazy_seeds=True)
    for m in (meta, lazy):
        nh3 = kernels.seed_tables_cuda(m, idx, packed, lens)
        assert torch.equal(nh3, mk.seed_tables(m, idx, packed, lens))
        assert (nh3[..., 1] >= 0).any()
        got = kernels.walk_cuda(m, idx, packed, lens, nh3)
        want = mk.walk(m, idx, packed, lens, nh3)
        torch.cuda.synchronize()
        for f in want._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("serving", [False, True],
                         ids=["whole", "mphf-serving"])
@pytest.mark.parametrize("W", sorted(RECORD_KL))
def test_mphf_record_stats_match_plain_on_cuda(W, serving):
    """K3 on the record layout of the whole upload and of the MPHF serving
    upload against the plain counts, tolerance 0, false positives
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k, L = RECORD_KL[W]
    meta, idx, packed, lens = _case(k, L, dict(seed_index="mphf"), "cuda",
                                    serving=serving)
    got = kernels.stats_cuda(meta, idx, packed, lens)
    want = stats.stats_counts(meta, idx, packed, lens)
    torch.cuda.synchronize()
    assert got.tolist() == want.tolist()
    assert got[1] > 0 and got[2] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("W", sorted(RECORD_KL))
def test_mphf_record_lookup_matches_plain_on_cuda(W):
    """K8's lookup, which verifies through the same record helper as K1,
    against dynamic_verified_lookup on each of two shards: keys, aliens
    and all-zero queries, tolerance 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pseudoaligner_torch.ops.mphf_lookup import dynamic_verified_lookup
    from pseudoaligner_torch.parallel import sharded_index as si

    k, L = RECORD_KL[W]
    image, _ = _data(np.random.default_rng(k + L), k, L)
    lookup, n_levels = si.build_sharded_lookup(image, 2)
    rng = np.random.default_rng(W)
    keys = image.kmer_keys
    q = np.concatenate([keys, rng.integers(0, 2**32, (500, W),
                                           dtype=np.uint64).astype(np.uint32),
                        np.zeros((300, W), np.uint32)])
    qt = torch.from_numpy(q[rng.permutation(len(q))].view(np.int32))
    qt = qt.to("cuda")
    hits = 0
    for s in range(2):
        shard = si.upload_lookup(lookup, s, "cuda")
        got = kernels.mphf_dynamic_cuda(qt, shard, n_levels)
        want = dynamic_verified_lookup(qt, shard, n_levels)
        torch.cuda.synchronize()
        assert torch.equal(got, want), s
        hits += int((got[:, 0] >= 0).sum())
    assert hits >= len(keys)


def _ec_inputs(rng, B, M, TW, n_ecs, device):
    """Random full-output node buffers (with -1 holes, n_nodes past the
    buffer, unmapped rows) over a random node -> class table, and random
    class bitsets of TW words."""
    n_nodes_tab = 3 * n_ecs
    node_row = np.zeros((n_nodes_tab, 12), np.int32)
    node_row[:, 3] = rng.integers(0, n_ecs, n_nodes_tab)
    bits = rng.integers(0, 2**32, (n_ecs, TW), dtype=np.uint64)
    bits |= rng.integers(0, 2**32, (n_ecs, TW), dtype=np.uint64)  # dense
    nodes = rng.integers(0, n_nodes_tab, (B, M)).astype(np.int32)
    nodes[rng.random((B, M)) < 0.05] = -1
    n_nodes = rng.integers(0, M + 5, B).astype(np.int32)
    nodes[np.arange(M)[None, :] >= n_nodes[:, None]] = -1
    mapped = (n_nodes > 0) & (rng.random(B) < 0.9)
    idx = mk.DeviceIndex(**{f.name: torch.zeros(0, dtype=torch.int32,
                                                device=device)
                            for f in dataclasses.fields(mk.DeviceIndex)})
    idx.node_row = torch.from_numpy(node_row).to(device)
    idx.ec_bits = torch.from_numpy(
        bits.astype(np.uint32).view(np.int32)).to(device)
    meta = mk.MapMeta(k=20, read_len=64, allowed_mismatches=2,
                      left_extend_fraction=0.2, max_nodes=M, cuckoo_mask=0,
                      tx_words=TW)
    return (meta, idx, torch.from_numpy(nodes).to(device),
            torch.from_numpy(n_nodes).to(device),
            torch.from_numpy(mapped).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("M,TW", [(8, 1), (64, 33), (120, 337), (64, 512)])
def test_ec_bits_kernel_matches_plain_on_cuda(M, TW):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _ec_inputs(np.random.default_rng(M + TW), 1000, M, TW, 50,
                      "cuda")
    got = kernels.ec_bits_cuda(*args)
    want = mk.ec_bitset_intersect(*args)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    assert (got != 0).any() and (got == 0).all(dim=1).any()


EC_KEPT = 16  # csrc/ecbits.cu's C: distinct classes a read keeps on chip
EC_READS = 8  # csrc/ecbits.cu's R: reads per block


def _ec_edge_case(entry, B, TW, device, M=120):
    """K4 inputs that reach every branch of either entry ("nodes" or
    "classes"), one kind of read per row (the first eight rows one of each,
    the rest drawn): 0 a few classes with -1 holes; 1 M distinct classes
    (more than EC_KEPT: the overflow path); 2 mapped, every id -1; 3
    n_nodes above M, 20 classes; 4 n_nodes below 0; 5 unmapped; 6 and 7
    exactly EC_KEPT and EC_KEPT + 1 classes spread over every chunk of 32
    ids.  Classes 0-149 have dense random bitsets, 150-299 all-ones bar
    about one bit in 256, so that an AND over M of them stays nonzero.
    Node n has class n % 300.  -> (kernel wrapper, plain function, args,
    kinds)."""
    rng = np.random.default_rng(1000 * B + TW)
    n_ecs = 300
    node_row = np.zeros((3 * n_ecs, 12), np.int32)
    node_row[:, 3] = np.arange(3 * n_ecs) % n_ecs
    dense = rng.integers(0, 2**32, (n_ecs, TW), dtype=np.uint64)
    dense |= rng.integers(0, 2**32, (n_ecs, TW), dtype=np.uint64)
    holes = np.full((n_ecs, TW), 2**32 - 1, np.uint64)
    for _ in range(8):
        holes &= rng.integers(0, 2**32, (n_ecs, TW), dtype=np.uint64)
    bits = np.where(np.arange(n_ecs)[:, None] < 150, dense, ~holes
                    & np.uint64(2**32 - 1)).astype(np.uint32)
    nodes = np.full((B, M), -1, np.int32)
    n_nodes = np.full(B, M, np.int32)
    mapped = np.ones(B, bool)
    kinds = [b if b < 8 else int(rng.integers(8)) for b in range(B)]
    for b, kind in enumerate(kinds):
        if kind == 2:
            continue
        if kind == 1:
            cls = 150 + rng.permutation(150)[:M]
        else:
            n_cls = {0: int(rng.integers(1, 4)), 3: 20, 6: EC_KEPT,
                     7: EC_KEPT + 1}.get(kind, 3)
            pick = rng.permutation(150)[:n_cls] + (0 if kind in (0, 4, 5)
                                                  else 150)
            cls = pick[np.r_[np.arange(n_cls),
                             rng.integers(0, n_cls, M - n_cls)]]
            cls = rng.permutation(cls)
        nodes[b] = cls + n_ecs * rng.integers(0, 3, M)
        if kind == 0:
            n_nodes[b] = rng.integers(1, M + 1)
            nodes[b, rng.random(M) < 0.05] = -1
            nodes[b, n_nodes[b]:] = -1
        n_nodes[b] = {3: M + 7, 4: -3}.get(kind, n_nodes[b])
        mapped[b] = kind != 5
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    idx = mk.DeviceIndex(**{f.name: torch.zeros(0, dtype=torch.int32,
                                                device=device)
                            for f in dataclasses.fields(mk.DeviceIndex)})
    idx.node_row = t(node_row)
    idx.ec_bits = t(bits.view(np.int32))
    meta = mk.MapMeta(k=20, read_len=64, allowed_mismatches=2,
                      left_extend_fraction=0.2, max_nodes=M, cuckoo_mask=0,
                      tx_words=TW)
    if entry == "nodes":
        ids, fns = nodes, (kernels.ec_bits_cuda, mk.ec_bitset_intersect)
    else:
        ids = np.where(nodes >= 0, node_row[nodes.clip(0), 3], -1)
        fns = (kernels.ec_bits_classes_cuda, mk.ec_bitset_intersect_classes)
    return (*fns, (meta, idx, t(ids.astype(np.int32)), t(n_nodes),
                   t(mapped)), kinds)


def _ec_edge_check(entry, B, TW, device):
    """The kernel's entry equals its plain version on _ec_edge_case's
    inputs, and the plain version holds each kind's meaning."""
    cuda, plain, args, kinds = _ec_edge_case(entry, B, TW, device)
    before = cuda.launches
    got = cuda(*args)
    want = plain(*args)
    if device == "cuda":
        torch.cuda.synchronize()
    assert cuda.launches == before + 1
    assert got.dtype == want.dtype == torch.int32
    assert got.shape == want.shape == (B, TW)
    assert torch.equal(got, want)
    _ec_kinds_hold(want, kinds)


def _ec_kinds_hold(bits, kinds):
    for b, kind in enumerate(kinds):
        if kind in (2, 4):  # mapped, no usable id: all-ones
            assert (bits[b] == -1).all()
        elif kind == 5:
            assert (bits[b] == 0).all()
        elif kind == 1:  # M classes whose AND keeps about 63% of the bits
            assert (bits[b] != 0).any()


@pytest.mark.parametrize("TW", [1, 33])
def test_ec_bits_edge_kinds_on_cpu(TW):
    """The plain intersections on _ec_edge_case's reads: the node-id and
    class-id entries agree, each kind of read holds its meaning, and every
    row is the AND of its classes' rows as numpy computes it."""
    B = 2 * EC_READS + 1
    _, nodes_fn, args, kinds = _ec_edge_case("nodes", B, TW, "cpu")
    _, classes_fn, cargs, ckinds = _ec_edge_case("classes", B, TW, "cpu")
    assert kinds == ckinds
    got = nodes_fn(*args)
    assert torch.equal(got, classes_fn(*cargs))
    _ec_kinds_hold(got, kinds)
    meta, idx, classes, n_nodes, mapped = cargs
    table = idx.ec_bits.numpy()
    for b in range(B):
        want = np.full(TW, -1, np.int32)
        for e in classes[b, :max(min(int(n_nodes[b]), meta.max_nodes),
                                 0)].tolist():
            if e >= 0:
                want &= table[e]
        assert np.array_equal(got[b].numpy(), want if mapped[b] else 0 * want)


@pytest.mark.gpu
@pytest.mark.parametrize("TW", [1, 3, 33, 337, 512])
@pytest.mark.parametrize("B", [1, 3, EC_READS + 1, 1000])
@pytest.mark.parametrize("entry", ["nodes", "classes"])
def test_ec_bits_edges_match_plain_on_cuda(entry, B, TW):
    """Both K4 entries against their plain versions, tolerance 0, at batch
    sizes around a block of reads and word widths that do and do not fill
    16-byte pieces (TW 1, 3 and 33 put pieces across row ends), with
    every kind of read of _ec_edge_case at max_nodes 120."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _ec_edge_check(entry, B, TW, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k,L", [(20, 64), (64, 96)])
def test_ec_bits_on_the_map_path_on_cuda(k, L):
    """map_batch_packed in the full-output shape launches K4, and its
    ec_bits equal the plain step's on the same index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kw = dict(distinct_cap=0, max_nodes=8)
    meta, idx, packed, lens = _case(k, L, kw, "cuda")
    assert meta.tx_words > 0
    before = kernels.ec_bits_cuda.launches
    got = mk.map_batch_packed(meta, idx, packed, lens)
    assert kernels.ec_bits_cuda.launches == before + 1
    want = mk.ec_bitset_intersect(meta, idx, got.nodes, got.n_nodes,
                                  got.mapped)
    torch.cuda.synchronize()
    assert torch.equal(got.ec_bits.view(torch.int32), want)


@pytest.mark.gpu
@pytest.mark.parametrize("k,L", [(20, 64), (64, 96)])
def test_unpack_kernel_matches_plain_on_cuda(k, L):
    """K5 rebuilds the plain upload's cuckoo arrays from the packed ones
    (keys and values packed at k = 20, values only at k = 64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    image, _ = _data(np.random.default_rng(k), k, L)
    cfg = AlignerConfig(k=k, max_read_len=L)
    dev_np, meta = mk.device_index_from_image(image, cfg)
    args, pcfg = mk.pack_serving_args(dev_np, meta)
    assert pcfg.pack_keys == (k == 20)
    t = mk.packed_tensors(args, "cuda")
    before = kernels.unpack_index_cuda.launches
    got = kernels.unpack_index_cuda(t, pcfg)
    assert kernels.unpack_index_cuda.launches == before + 1
    want = mk.unpack_index(t, pcfg)
    plain = mk.upload(dev_np, "cuda", serving=meta, pack=False)
    packed = mk.upload(dev_np, "cuda", serving=meta, pack=True)
    torch.cuda.synchronize()
    for a, b, c, d in zip(got, want, (plain.cuckoo, plain.cuckoo_vals),
                          (packed.cuckoo, packed.cuckoo_vals)):
        assert a.dtype == b.dtype == c.dtype == torch.int32
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    assert packed.nbytes() == plain.nbytes()


def test_cpu_tensors_take_the_plain_passes_ec_bits_and_unpack():
    """The bitset intersection and the packed upload's unpack take their
    plain versions for CPU tensors; their wrappers refuse CPU tensors."""
    meta, idx, packed, lens = _case(20, 64, dict(distinct_cap=0,
                                                 max_nodes=8), "cpu")
    before = (kernels.ec_bits_cuda.launches,
              kernels.unpack_index_cuda.launches)
    res = mk.map_batch_packed(meta, idx, packed, lens)
    assert res.ec_bits.shape == (packed.shape[0], meta.tx_words)
    assert (res.ec_bits.view(torch.int32) != 0).any()
    image, _ = _data(np.random.default_rng(20), 20, 64)
    dev_np, smeta = mk.device_index_from_image(
        image, AlignerConfig(k=20, max_read_len=64))
    up = mk.upload(dev_np, "cpu", serving=smeta, pack=True)
    assert torch.equal(up.cuckoo_vals,
                       mk.upload(dev_np, "cpu", serving=smeta).cuckoo_vals)
    assert (kernels.ec_bits_cuda.launches,
            kernels.unpack_index_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.ec_bits_cuda(meta, idx, res.nodes, res.n_nodes, res.mapped)
    args, pcfg = mk.pack_serving_args(dev_np, smeta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.unpack_index_cuda(
            mk.packed_tensors(args, "cpu"), pcfg)


def test_cpu_tensors_take_the_plain_passes():
    meta, idx, packed, lens = _case(*SHAPES["serving"], "cpu")
    before = (kernels.seed_tables_cuda.launches, kernels.walk_cuda.launches)
    res = mk.map_batch_packed(meta, idx, packed, lens)
    assert res.mapped.any()
    assert (kernels.seed_tables_cuda.launches,
            kernels.walk_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.seed_tables_cuda(meta, idx, packed, lens)
    nh3 = mk.seed_tables(meta, idx, packed, lens)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.walk_cuda(meta, idx, packed, lens, nh3)
    meta, idx, packed, lens = _case(*SHAPES["serving"], "cpu", serving=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.stats_cuda(meta, idx, packed, lens)
    before = kernels.stats_cuda.launches
    assert stats.batch_stats(meta, idx, packed, lens).n_positions > 0
    assert kernels.stats_cuda.launches == before


@pytest.mark.parametrize("mode", ["cuckoo", "bucket1", "mphf"])
def test_seed_index_checks(mode):
    """The wrappers' argument checks accept each mode's serving upload and
    refuse a serving upload of another mode (row widths, empty MPHF
    arrays); stats needs the MPHF arrays whatever the mode."""
    kw = dict(SHAPES["serving"][2], seed_index=mode)
    meta, idx, _, _ = _case(20, 64, kw, "cpu")
    dev = torch.device("cpu")
    kernels._check_seed_index(meta, idx, dev)
    other = "mphf" if mode != "mphf" else "bucket1"
    other_meta, served, _, _ = _case(20, 64, dict(kw, seed_index=other),
                                     "cpu")
    with pytest.raises(ValueError):
        kernels._check_seed_index(meta, served, dev)
    if mode != "mphf":  # a cuckoo or bucket1 serving upload has no MPHF
        with pytest.raises(ValueError, match="MPHF arrays"):
            kernels._check_mphf(meta, idx, dev)
        with pytest.raises(ValueError, match="full DeviceIndex"):
            stats.batch_stats(meta, idx, *_case(20, 64, kw, "cpu")[2:])
    p = kernels._params(meta, 5).tolist()
    n = p[kernels.PARAM_NAMES.index("n_levels")]
    assert 0 < n <= kernels.MAX_LEVELS
    assert len(p) == len(kernels.PARAM_NAMES) + 4 * n
    assert p[kernels.PARAM_NAMES.index("mode")] == mk.SEED_INDEXES.index(mode)
    assert tuple(p[len(kernels.PARAM_NAMES):][:n]) == meta.mphf.seeds


def test_index_arrays_must_be_aligned():
    """The kernels read node rows and bucket rows in 16-byte loads: the
    wrappers refuse index arrays that do not start on 16 bytes."""
    whole = torch.zeros(13, dtype=torch.int32)
    kernels._check_aligned("node_row", whole[:12])
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels._check_aligned("node_row", whole[1:])


def test_graph_walk_buffers_must_be_aligned(monkeypatch):
    """K10 and K11 move state rows, push buffers, responses, node rows and
    pool words in 16-byte accesses and requests in 8-byte ones: each
    wrapper refuses a tensor that does not start there, before it loads
    the kernels, and lets aligned ones through to the launch."""
    from pseudoaligner_torch.parallel import graph_walk as gw

    class Launched(Exception):
        pass

    def no_load():
        raise Launched

    monkeypatch.setattr(kernels, "_require_cuda", lambda t: None)
    monkeypatch.setattr(kernels, "_load", no_load)
    meta = mk.MapMeta(k=20, read_len=60, allowed_mismatches=2,
                      left_extend_fraction=0.2, max_nodes=7,
                      cuckoo_mask=1023, distinct_cap=3, lazy_seeds=False)
    S, B, M, ww, P = 2, 8, 7, gw.window_words(meta), meta.n_positions
    km = types.SimpleNamespace(n_shards=S, node_block=10)

    def z(*shape, off=0):
        """A zero int32 tensor of `shape` starting `off` words into a
        storage that starts on 16 bytes."""
        n = int(np.prod(shape))
        return torch.zeros(n + 4, dtype=torch.int32)[off:off + n].view(shape)

    # (tensor, the bytes its accesses need, the call with it `off` words in)
    cases = [
        ("st", 16, lambda o: kernels.gwalk_finish_cuda(
            meta, km, z(B, 12, off=o), z(B, M, 2))),
        ("buf", 16, lambda o: kernels.gwalk_left_b_cuda(
            meta, km, z(S, B, 12), z(B, 12), z(B, M, 2, off=o), z(S, B, 2))),
        ("req", 8, lambda o: kernels.gwalk_init_cuda(
            meta, km, z(B, P, 3), z(B), z(B, 12), z(B, M, 2),
            z(S, B, 2, off=o), z(S, B, 2))),
        ("back", 16, lambda o: kernels.gwalk_forward_cuda(
            meta, km, z(B, 4), z(B), z(B, P, 3), z(S, B, 12 + ww, off=o),
            z(B, 12), z(B, M, 2), z(S, B, 2))),
        ("back", 16, lambda o: kernels.gwalk_left_a_cuda(
            meta, km, z(B, 4), z(S, B, 12 + ww, off=o), z(B, 12),
            z(S, B, 2))),
        ("recv", 8, lambda o: kernels.gfetch_cuda(
            km, 1, z(S, B, 2, off=o), z(10, 12), z(64), ww)),
        ("node_rows", 16, lambda o: kernels.gfetch_cuda(
            km, 1, z(S, B, 2), z(10, 12, off=o), z(64), ww)),
        ("pool", 16, lambda o: kernels.gfetch_cuda(
            km, 1, z(S, B, 2), z(10, 12), z(64, off=o), ww)),
    ]
    for name, nbytes, call in cases:
        with pytest.raises(Launched):
            call(0)
        with pytest.raises(ValueError, match=f"{name}: data not {nbytes}-"):
            call(1)
        if nbytes == 16:
            with pytest.raises(ValueError, match=f"{name}: data not 16-"):
                call(2)
        else:
            with pytest.raises(Launched):
                call(2)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolchain: the build raises (and the CUDA path with it) instead
    of falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build()
    assert not (tmp_path / "build").exists()


def test_launch_params_order():
    meta = mk.MapMeta(k=20, read_len=60, allowed_mismatches=2,
                      left_extend_fraction=0.2, max_nodes=7,
                      cuckoo_mask=1023, ones_node=5, ones_off=6,
                      distinct_cap=3, lazy_seeds=True, max_walk_iters=3,
                      max_left_iters=2, ec_out_16=True, cov_out_8=True)
    v = kernels._params(meta, 11).tolist()
    p = dict(zip(kernels.PARAM_NAMES, v))
    assert p == dict(B=11, nw=4, L=60, k=20, lazy=1, cuckoo_mask=1023,
                     ones_node=5, ones_off=6, allowed=2, max_nodes=7, lcap=2,
                     wcap=3, dc=3, ec16=1, cov8=1, mode=0, bucket_seed=0,
                     n_levels=0)
    assert len(v) == len(kernels.PARAM_NAMES)
    with pytest.raises(ValueError, match="distinct_cap"):
        kernels.walk_cuda(dataclasses.replace(meta, distinct_cap=65),
                          None, torch.zeros(1), None, None)


def _route_case(S, cap_scale, device):
    """A batch of the _data reads (short and empty rows included), its
    packed words and lens on `device`, one shard's lookup of a k-mer
    partition of the index at S shards, and the send capacity."""
    from pseudoaligner_torch.parallel import sharded_index as si

    image, reads = _data(np.random.default_rng(7), 20, 64)
    codes = np.zeros((len(reads) + 5, 64), np.int32)
    lens = np.zeros(len(codes), np.int32)
    for j, w in enumerate(reads):
        codes[j, : len(w)] = w
        lens[j] = len(w)
    lookup, n_levels = si.build_sharded_lookup(image, S)
    P = 64 - 20 + 1
    cap = (max(8, int(cap_scale * len(codes) * P / S / S)) + 7) // 8 * 8
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(lens).to(device), lookup, n_levels, cap)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("cap_scale", [4.0, 0.3])
def test_multi_device_kernels_match_plain_on_cuda(S, cap_scale):
    """K6 pack, K7 route and unscatter (with and without overflow), K8
    dynamic MPHF probe on every shard, K1's next_hit entry and K9 counts
    against their plain versions on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pseudoaligner_torch.ops.mphf_lookup import dynamic_verified_lookup
    from pseudoaligner_torch.parallel import mesh, sharded_index as si

    codes, lens, lookup, n_levels, cap = _route_case(S, cap_scale, "cuda")
    packed = kernels.pack_reads_cuda(codes)
    assert torch.equal(packed, mk.pack_reads_device(codes))
    assert torch.equal(kernels.pack_reads_cuda(codes.to(torch.uint8)),
                       packed)
    got = kernels.route_cuda(packed, lens, 20, 64, S, cap)
    want = si.route_queries(packed, lens, 20, 64, S, cap)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    if cap_scale < 1:
        assert int(got[2]) > 0 and got[3].any()
    for s in range(S):
        shard = si.upload_lookup(lookup, s, "cuda")
        q = got[0].reshape(S * cap, -1)
        res = kernels.mphf_dynamic_cuda(q, shard, n_levels)
        assert torch.equal(res, dynamic_verified_lookup(q, shard, n_levels))
    src = got[1].reshape(-1)
    B = codes.shape[0]
    node, off = kernels.unscatter_cuda(res, src, B, 45)
    pnode, poff = si.unscatter_seeds(res, src, B, 45)
    assert torch.equal(node, pnode) and torch.equal(off, poff)
    nh3 = kernels.next_hit_cuda(node, off, lens, 20)
    assert torch.equal(nh3, mk.next_hit_table(node, off, lens, 20, 45))
    bits = torch.randint(-2**31, 2**31, (3000, 11), dtype=torch.int32,
                         device="cuda")
    bits[::3] = 0
    for n_tx in (1, 330, 352):
        assert torch.equal(kernels.tx_counts_cuda(bits, n_tx),
                           mesh.tx_compat_counts(bits, n_tx))
    torch.cuda.synchronize()


PACK_BLOCK = 256  # csrc/pack.cu: a block's threads, a word each


def _pack_check(B, L, dtype, device):
    """K6's entry for `dtype` against the plain pack, tolerance 0: codes
    0-3 (also against the host pack) and 0-255 (not masked to two bits:
    high bits bleed into the next bases' places), on a tensor of its own
    and on contiguous views whose base lies 1 to 15 bytes off 16-byte
    alignment (the kernel reads codes at any address, in wide loads only
    where aligned); each call adds one to its own entry's counter and
    leaves the other's alone."""
    rng = np.random.default_rng(1000 * B + L)
    ours = {np.uint8: kernels.pack_reads_u8_cuda,
            np.int32: kernels.pack_reads_i32_cuda}
    other = ours[np.int32 if dtype is np.uint8 else np.uint8]
    n = B * L
    for hi in (4, 256):
        flat = torch.from_numpy(rng.integers(0, hi, n + 16).astype(dtype))
        flat = flat.to(device)
        offs = (1, 3, 15) if dtype is np.uint8 else (1, 3)
        for codes in [flat[:n].clone().view(B, L)] + [
                flat[o:o + n].view(B, L) for o in offs]:
            assert codes.is_contiguous()
            before = (ours[dtype].launches, other.launches)
            got = kernels.pack_reads_cuda(codes)
            if device == "cuda":
                torch.cuda.synchronize()
            assert (ours[dtype].launches, other.launches) == (
                before[0] + 1, before[1])
            want = mk.pack_reads_device(codes)
            assert got.dtype == want.dtype == torch.int32
            assert torch.equal(got, want), (B, L, dtype, hi,
                                            codes.data_ptr() % 16)
            if hi == 4:
                host = mk.pack_reads_host(codes.cpu().numpy().astype(
                    np.uint8))
                assert np.array_equal(got.cpu().numpy().view(np.uint32),
                                      host)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.uint8, np.int32],
                         ids=["uint8", "int32"])
@pytest.mark.parametrize("L", [16, 37, 60, 64, 101])
@pytest.mark.parametrize("B", [1, 63, 1000])
def test_pack_entries_match_plain_on_cuda(B, L, dtype):
    """Both K6 entries at the widths of the tests and the kpart path, for
    one read and for batches whose last block of PACK_BLOCK words is
    partial."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert B * ((L + 15) // 16) % PACK_BLOCK or B == 1
    _pack_check(B, L, dtype, "cuda")


def test_pack_reads_dispatch_on_cpu():
    """map_kernel.pack_reads: uint8, int32 and int64 codes on the CPU give
    the same words through the plain pack and launch nothing; K6's wrapper
    takes uint8 and int32 and refuses other dtypes."""
    codes = np.random.default_rng(3).integers(0, 4, (70, 37))
    before = [fn.launches for fn in kernels.WRAPPERS]
    got = [mk.pack_reads(torch.from_numpy(codes.astype(dt)))
           for dt in (np.uint8, np.int32, np.int64)]
    assert [fn.launches for fn in kernels.WRAPPERS] == before
    want = mk.pack_reads_host(codes.astype(np.uint8))
    for g in got:
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy().view(np.uint32), want)
    with pytest.raises(TypeError, match="uint8 or torch.int32"):
        kernels.pack_reads_cuda(torch.from_numpy(codes))
    for dt in (np.uint8, np.int32):
        with pytest.raises(ValueError, match="CUDA tensors"):
            kernels.pack_reads_cuda(torch.from_numpy(codes.astype(dt)))


TX_PLANES = (8, 13)  # csrc/txcounts.cu: a thread's planes, a block's


def _tx_edge_check(B, TW, device):
    """K9 against its plain version, tolerance 0, on random words with an
    all-ones word 0 (its counts reach B: past a thread's and a block's
    planes at B = 2^P + 1) and rows zero but for it, for n_tx 1, 32 TW - 5
    and 32 TW: on the B rows, on the rows after the first (a base off 16
    bytes when TW % 4 != 0) and on no rows at all."""
    from pseudoaligner_torch.parallel import mesh

    rng = np.random.default_rng(10 * B + TW)
    full = rng.integers(-2**31, 2**31, (B + 1, TW), dtype=np.int64).astype(
        np.int32)
    full[2::5, 1:] = 0
    full[:, 0] = -1
    full = torch.from_numpy(full).to(device)
    for bits in (full[:B], full[1:], full[:0]):
        assert bits.is_contiguous()
        for n_tx in (1, 32 * TW - 5, 32 * TW):
            if n_tx < 1:
                continue
            before = kernels.tx_counts_cuda.launches
            got = kernels.tx_counts_cuda(bits, n_tx)
            # no rows: zero counts (the plain version, like the reference's,
            # cannot reshape an empty batch)
            want = (mesh.tx_compat_counts(bits, n_tx) if len(bits) else
                    torch.zeros(n_tx, dtype=torch.int32, device=device))
            if device == "cuda":
                torch.cuda.synchronize()
            assert kernels.tx_counts_cuda.launches == before + 1
            assert got.dtype == want.dtype == torch.int32
            assert torch.equal(got, want), (B, TW, n_tx)
            assert (want[:min(32, n_tx)] == bits.shape[0]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("TW", [1, 3, 11, 337])
@pytest.mark.parametrize("B", [1, 3, 2**TX_PLANES[0] + 1, 3000,
                               2**TX_PLANES[1] + 1])
def test_tx_counts_edges_match_plain_on_cuda(B, TW):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _tx_edge_check(B, TW, "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("polya", [True, False],
                         ids=["polyA-key", "no-polyA"])
def test_mphf_dynamic_zero_queries_match_plain_on_cuda(polya):
    """K8 on zero-heavy send buffers (three slots in four all-zero, as at
    S = 1, and all-zero queries among the real ones): its one probe of the
    zero key gives every zero slot the plain probe's answer, where poly-A
    is a key and where it is not, at every key width (k = 15, 20, 40, 64:
    W = 1-4, 16- and 32-byte records)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pseudoaligner_torch.ops.mphf_lookup import dynamic_verified_lookup
    from pseudoaligner_torch.parallel import sharded_index as si

    rng = np.random.default_rng(11 + polya)
    seqs = [rng.integers(0, 4, int(rng.integers(200, 500))).astype(np.uint8)
            for _ in range(12)]
    if polya:
        seqs.append(np.zeros(160, np.uint8))  # poly-A: the all-zero k-mer
    names = [f"t{i}" for i in range(len(seqs))]
    gmap = {n: "g" for n in names}
    for k in (15, 20, 40, 64):
        image = build_index(seqs, names, gmap, k=k)
        assert np.all(image.kmer_keys == 0, axis=1).any() == polya
        lookup, n_levels = si.build_sharded_lookup(image, 1)
        shard = si.upload_lookup(lookup, 0, "cuda")
        keys = image.kmer_keys
        n = len(keys)
        q = np.zeros((4 * n + 37, keys.shape[1]), np.uint32)
        q[:n] = keys[rng.permutation(n)]
        q[rng.integers(0, n, 9)] = 0
        q[n:n + 300:3] = rng.integers(0, 2**31, (100, keys.shape[1]))
        qt = torch.from_numpy(q.view(np.int32)).to("cuda")
        got = kernels.mphf_dynamic_cuda(qt, shard, n_levels)
        want = dynamic_verified_lookup(qt, shard, n_levels)
        torch.cuda.synchronize()
        assert torch.equal(got, want), k
        pad = got[n + 300:]
        assert ((pad[:, 0] >= 0).all() if polya else (pad == -1).all()), k


def _graph_case(S, shape, device):
    """A graph-sharded KmerPartitionedAligner over S loopback shards on
    `device` and a batch of the _data reads (a multiple of S rows) ->
    (aligner, the same engine with the graph replicated, codes, lens)."""
    from pseudoaligner_torch.parallel import sharded_index as si
    from pseudoaligner_torch.parallel.mesh import make_mesh

    k, L, kw = SHAPES[shape]
    image, reads = _data(np.random.default_rng(k + L + S), k, L)
    B = len(reads) // 8 * 8
    codes = np.zeros((B, L), np.int32)
    lens = np.zeros(B, np.int32)
    for j, w in enumerate(reads[:B - 3]):  # three empty rows
        codes[j, : len(w)] = w
        lens[j] = len(w)
    cfg = AlignerConfig(k=k, max_read_len=L, batch_size=B,
                        **dict(kw, lazy_seeds=False))
    made = [si.KmerPartitionedAligner(
        image, cfg, make_mesh(S, loopback=True, device=device),
        shard_graph=sg) for sg in (True, False)]
    return made[0], made[1], codes, lens


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("shape", ["serving", "full_eager_seeds", "k64"])
def test_graph_walk_kernels_match_plain_on_cuda(S, shape):
    """Every launch of K10's steps and K11 in a graph-sharded walk against
    its plain step on copies of the same inputs, tolerance 0; the walk's
    MapResult and counts equal the replicated engine's (K2, K4), and in
    the full-output shape K4's entry from class ids equals its plain
    version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pseudoaligner_torch.parallel import graph_walk as gw

    kp, rep, codes, lens = _graph_case(S, shape, "cuda")
    err = {}
    kp.walk_steps = gw.paired_steps(gw.kernel_steps(), gw.PLAIN_STEPS, err)
    before = [fn.launches for fn in kernels.GWALK_WRAPPERS] + [
        kernels.gfetch_cuda.launches]
    got, counts = kp.map_batch(codes, lens)
    want, want_counts = rep.map_batch(codes, lens)
    torch.cuda.synchronize()
    after = [fn.launches for fn in kernels.GWALK_WRAPPERS] + [
        kernels.gfetch_cuda.launches]
    assert set(err) == set(gw.Steps._fields) and not any(err.values()), err
    assert all(a > b for a, b in zip(after, before))
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a, b.view(torch.int32)
                           if b.dtype == torch.uint32 else b), f
    assert torch.equal(counts, want_counts)
    if kp.meta.tx_words and not kp.meta.distinct_cap:
        classes = torch.where(got.nodes >= 0, rep.dev.node_row[
            got.nodes.clamp(min=0).long(), 3], -1)
        args = (kp.meta, kp.dev, classes, got.n_nodes, got.mapped)
        assert torch.equal(kernels.ec_bits_classes_cuda(*args),
                           mk.ec_bitset_intersect_classes(*args))


def _gfetch_edge_case(S, B, ww, device):
    """A block of Nb = 40 node rows whose starts run to the pool's last
    words, and requests [S, B, 2] for shard me = S - 1: no request (-1),
    the block's first and last nodes, nodes outside it (clipped into it),
    deltas that put the window start below 0 (clamped to 0) and windows
    that reach the pool's last word and beyond -> (kmeta, me, recv,
    node_rows, pool) on `device`."""
    import types

    rng = np.random.default_rng(1000 * S + 10 * B + ww)
    Nb, R, me = 40, 96, S - 1
    rows = rng.integers(-2**31, 2**31, (Nb, 12), dtype=np.int64).astype(
        np.int32)
    rows[:, 0] = rng.integers(0, 16 * R, Nb)
    rows[-3:, 0] = 16 * R - np.array([1, 9, 16 * (ww + 1)])
    pool = rng.integers(-2**31, 2**31, R, dtype=np.int64).astype(np.int32)
    lo = me * Nb
    nodes = np.concatenate([[-1, lo, lo + Nb - 1, lo - 1, lo + Nb + 5,
                             -7, lo + Nb - 2, lo + Nb - 3],
                            rng.integers(lo - 5, lo + Nb + 5, S * B)])
    deltas = np.concatenate([[0, -10**6, 17, 0, -5, 3, 0, 15],
                             rng.integers(-300, 300, S * B)])
    recv = np.stack([nodes, deltas], -1)[:S * B].astype(np.int32)
    if S * B > 1:  # a request that sits on the pool's last word
        recv[1] = (lo + Nb - 1, 0)
    recv = recv.reshape(S, B, 2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (types.SimpleNamespace(n_shards=S, node_block=Nb), me, t(recv),
            t(rows), t(pool))


@pytest.mark.gpu
@pytest.mark.parametrize("ww", [0, 4, 19])
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 33, 129])
def test_gfetch_edges_match_plain_on_cuda(B, S, ww):
    """K11 against its plain version, tolerance 0, at every response width
    kind (rows only, a multiple of 4 words, and 31 words, whose 16-byte
    pieces straddle slots), at batch sizes around its blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pseudoaligner_torch.parallel import graph_walk as gw

    args = _gfetch_edge_case(S, B, ww, "cuda")
    before = kernels.gfetch_cuda.launches
    got = kernels.gfetch_cuda(*args, ww)
    want = gw.serve_fetch(*args, ww)
    torch.cuda.synchronize()
    assert kernels.gfetch_cuda.launches == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def _graph_edge_case(S, shape, device):
    """_graph_case's engines at b = 421 rows per shard (three whole blocks
    of 128 lanes and 37 more), rows 128-383 of each shard empty (two
    whole blocks of inactive lanes), in the serving shape (max_nodes 7)
    or the full output at max_nodes 192."""
    from pseudoaligner_torch.parallel import sharded_index as si
    from pseudoaligner_torch.parallel.mesh import make_mesh

    k, L = 20, 64
    kw = (SHAPES["serving"][2] if shape == "serving" else
          dict(distinct_cap=0, max_nodes=192))
    image, reads = _data(np.random.default_rng(k + L + S), k, L)
    b = 3 * 128 + 37
    codes = np.zeros((S * b, L), np.int32)
    lens = np.zeros(S * b, np.int32)
    j = 0
    for row in range(S * b):
        if 128 <= row % b < 384:
            continue
        w = reads[j % len(reads)]
        j += 1
        codes[row, : len(w)] = w
        lens[row] = len(w)
    cfg = AlignerConfig(k=k, max_read_len=L, batch_size=S * b,
                        **dict(kw, lazy_seeds=False))
    made = [si.KmerPartitionedAligner(
        image, cfg, make_mesh(S, loopback=True, device=device),
        shard_graph=sg) for sg in (True, False)]
    return made[0], made[1], codes, lens


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("shape", ["serving", "full_192"])
def test_graph_walk_kernel_edges_match_plain_on_cuda(S, shape):
    """Every K10 and K11 launch against its plain step through
    paired_steps, tolerance 0, at a per-shard batch that is no multiple of
    K10's block and holds whole blocks of empty reads; the MapResult
    equals the replicated engine's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pseudoaligner_torch.parallel import graph_walk as gw

    kp, rep, codes, lens = _graph_edge_case(S, shape, "cuda")
    err = {}
    kp.walk_steps = gw.paired_steps(gw.kernel_steps(), gw.PLAIN_STEPS, err)
    got, counts = kp.map_batch(codes, lens)
    want, want_counts = rep.map_batch(codes, lens)
    torch.cuda.synchronize()
    assert set(err) == set(gw.Steps._fields) and not any(err.values()), err
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a.view(torch.int32) if a.dtype == torch.uint32
                           else a, b.view(torch.int32)
                           if b.dtype == torch.uint32 else b), f
    assert torch.equal(counts, want_counts)


def test_graph_walk_plain_steps_on_cpu():
    """On CPU tensors the graph-sharded walk takes the plain steps: no
    K10, K11 or K4-from-classes launch; its results equal the replicated
    engine's; the wrappers refuse CPU tensors."""
    from pseudoaligner_torch.parallel import graph_walk as gw

    kp, rep, codes, lens = _graph_case(2, "full_eager_seeds", "cpu")
    before = [fn.launches for fn in kernels.WRAPPERS]
    got, counts = kp.map_batch(codes, lens)
    want, want_counts = rep.map_batch(codes, lens)
    assert [fn.launches for fn in kernels.WRAPPERS] == before
    for f in want._fields:
        assert torch.equal(getattr(got, f).view(torch.int32)
                           if f == "ec_bits" else getattr(got, f),
                           getattr(want, f).view(torch.int32)
                           if f == "ec_bits" else getattr(want, f)), f
    assert torch.equal(counts, want_counts) and counts.sum() > 0
    meta, km, S, B = kp.meta, kp.kmeta, 2, 8
    st = torch.zeros((B, gw.NSTATE), dtype=torch.int32)
    buf = torch.zeros((B, meta.max_nodes, 2), dtype=torch.int32)
    req = torch.zeros((S, B, 2), dtype=torch.int32)
    g = kp.graphs[0]
    for call in (
            lambda: kernels.gwalk_init_cuda(
                meta, km, torch.zeros((B, meta.n_positions, 3),
                                      dtype=torch.int32),
                torch.zeros(B, dtype=torch.int32), st, buf, req, req),
            lambda: kernels.gwalk_left_b_cuda(
                meta, km, torch.zeros((S, B, 12), dtype=torch.int32), st,
                buf, req),
            lambda: kernels.gwalk_finish_cuda(meta, km, st, buf),
            lambda: kernels.gfetch_cuda(km, 0, req, g.node_rows, g.pools, 4),
            lambda: kernels.ec_bits_classes_cuda(
                meta, kp.dev, buf[:, :, 1].contiguous(), st[:, 0],
                st[:, 0] > 0)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()


def test_cpu_tensors_take_the_plain_passes_multi_device():
    """The multi-device steps take the plain versions for CPU tensors and
    leave the launch counters alone; the new wrappers refuse CPU
    tensors."""
    from pseudoaligner_torch.parallel import sharded_index as si
    from pseudoaligner_torch.parallel.mesh import make_mesh

    codes, lens, lookup, n_levels, cap = _route_case(2, 4.0, "cpu")
    image, _ = _data(np.random.default_rng(7), 20, 64)
    before = [fn.launches for fn in kernels.WRAPPERS]
    kp = si.KmerPartitionedAligner(
        image, AlignerConfig(k=20, batch_size=codes.shape[0] - 1,
                             max_read_len=64, distinct_cap=0),
        make_mesh(2, loopback=True, device="cpu"))
    res, counts = kp.map_batch(codes[:-1].numpy(), lens[:-1].numpy())
    assert res.mapped.any() and counts.sum() > 0
    assert [fn.launches for fn in kernels.WRAPPERS] == before
    shard = si.upload_lookup(lookup, 0, "cpu")
    packed = mk.pack_reads_device(codes)
    nh_in = torch.zeros((2, 45), dtype=torch.int32)
    for call in (lambda: kernels.pack_reads_cuda(codes),
                 lambda: kernels.route_cuda(packed, lens, 20, 64, 2, cap),
                 lambda: kernels.unscatter_cuda(
                     torch.zeros((4, 2), dtype=torch.int32),
                     torch.zeros(4, dtype=torch.int32), 2, 45),
                 lambda: kernels.mphf_dynamic_cuda(
                     packed[:, :2].contiguous(), shard, n_levels),
                 lambda: kernels.next_hit_cuda(nh_in, nh_in, lens[:2], 20),
                 lambda: kernels.tx_counts_cuda(packed, 5)):
        with pytest.raises(ValueError, match="CUDA tensors"):
            call()
