"""The CUDA kernels (K1 seed, K2 walk, K3 stats, K4 bitset EC
intersection, K5 packed-upload unpack) against their plain PyTorch
versions, under each seed index (cuckoo, bucket1, MPHF).

The card tests carry the `gpu` marker and skip without a CUDA device;
chip_smoke.py runs the same comparison at full size on the card.  The CPU
tests pin the dispatch rule: CPU tensors take the plain passes and never
reach a kernel wrapper, and the wrappers refuse CPU tensors.

This file imports only the port (no jax, no pseudoaligner_tpu), so it
also runs where jax is absent (the GPU machine), without the repo's
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import dataclasses

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
