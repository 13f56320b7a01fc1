"""PyTorch port vs the JAX reference: cuckoo probe and the next-hit table
(the plain PyTorch side of the seed kernel K1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.dna import pack_kmers
from pseudoaligner_tpu.ops import map_kernel as ref_mk
from pseudoaligner_torch import spans
from pseudoaligner_torch.ops import map_kernel as mk

from .torch_helpers import (
    _fuzz_reads,
    assert_results_equal,
    build,
    make_batch,
    polyt_transcripts,
    port_index,
)

K_L = {20: 64, 64: 96}
_MAP_JIT = jax.jit(ref_mk.map_batch, static_argnums=0)


@pytest.fixture(scope="module", params=[20, 64])
def case(request):
    k = request.param
    rng = np.random.default_rng(300 + k)
    seqs, names, gmap = polyt_transcripts(rng)
    image = build(seqs, names, gmap, k=k)
    reads = _fuzz_reads(rng, seqs, k=k, n=160, L=K_L[k] - 8)
    reads.append(("polyT", np.full(K_L[k] - 4, 3, np.uint8)))
    return k, seqs, image, reads


@pytest.mark.parametrize("lazy", [True, False])
def test_seed_tables_match_reference(case, lazy):
    k, _, image, reads = case
    L = K_L[k]
    cfg = AlignerConfig(k=k, max_read_len=L, lazy_seeds=lazy,
                        pool_overlap=False)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    codes, lens = make_batch(reads, 192, L)
    ref = np.asarray(ref_mk._seed_tables(
        meta, dev_np, jnp.asarray(codes.astype(np.int32)),
        jnp.asarray(lens))[0])
    idx, pmeta = port_index(dev_np, meta)
    packed = torch.from_numpy(ref_mk.pack_reads_host(codes).view(np.int32))
    got = mk.seed_tables(pmeta, idx, packed, torch.from_numpy(lens))
    P = meta.n_positions
    # the table really holds hits, and lazy mode leaves residues 1, 2 empty
    # in the reference's: the port's lazy table holds the residue-0 rows
    # alone
    assert (ref[:, :, 0] < P).any()
    if lazy:
        assert (ref[:, np.arange(P) % 3 != 0] == [P, -1, -1]).all()
        ref = ref[:, ::3]
    assert got.dtype == torch.int32
    assert got.shape == (len(lens), pmeta.nh3_rows, 3) == ref.shape
    assert pmeta.nh3_rows == ((P + 2) // 3 if lazy else P)
    assert np.array_equal(got.numpy(), ref)


def test_lazy_meta_refuses_an_eager_table(case):
    """An expected difference (ROADMAP, C.1): under a lazy-seed meta the
    reference's map_batch_with_seeds walks a [B, P, 3] table, and the
    port's walk takes only its [B, ceil(P/3), 3] one and refuses it."""
    k, _, image, reads = case
    L = K_L[k]
    P = L - k + 1
    cfg = AlignerConfig(k=k, max_read_len=L, lazy_seeds=True,
                        pool_overlap=False)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    codes, lens = make_batch(reads, 64, L)
    reads_j = jnp.asarray(codes.astype(np.int32))
    nh3 = ref_mk._seed_tables(meta, dev_np, reads_j, jnp.asarray(lens))[0]
    assert nh3.shape == (64, P, 3)
    ref = ref_mk.map_batch_with_seeds(meta, dev_np, reads_j,
                                      jnp.asarray(lens), nh3)
    assert np.asarray(ref.mapped).any()
    idx, pmeta = port_index(dev_np, meta)
    assert pmeta.lazy_seeds and pmeta.nh3_rows == (P + 2) // 3
    with pytest.raises(ValueError, match="nh3"):
        mk.map_batch_with_seeds(
            pmeta, idx, torch.from_numpy(codes.astype(np.int32)),
            torch.from_numpy(lens), torch.from_numpy(np.array(nh3)))


def _snp_reads(rng, seqs, L, n):
    """Windows of L bases with one to three substitutions each."""
    reads = []
    for i in range(n):
        s = seqs[int(rng.integers(len(seqs)))]
        st = int(rng.integers(0, len(s) - L + 1))
        w = s[st : st + L].copy()
        for p in rng.integers(0, L, int(rng.integers(1, 4))):
            w[p] = (w[p] + 1 + rng.integers(0, 3)) % 4
        reads.append((f"snp{i}", w))
    return reads


@pytest.mark.parametrize("extra", [44, 42, 40, 0],
                         ids=["P%3=0", "P%3=1", "P%3=2", "L=k"])
def test_lazy_table_rows_and_map_match_reference(case, extra):
    """Under lazy seeds the port's table has ceil(P/3) rows, at each P % 3
    and at L = k (one row), and the step walking from it equals the
    reference's map_batch field by field.  A zero mismatch budget ends a
    segment at each substitution, so walks re-seed, on the residue-0 grid
    from the table's row kpos / 3."""
    k, seqs, image, _ = case
    L = k + extra
    P = L - k + 1
    rng = np.random.default_rng(L)
    reads = [(rid, w[:L]) for rid, w in
             _fuzz_reads(rng, seqs, k=k, n=120, L=max(L, k + 1))]
    reads += _snp_reads(rng, seqs, L, 160)
    cfg = AlignerConfig(k=k, max_read_len=L, lazy_seeds=True,
                        allowed_mismatches=0, distinct_cap=0,
                        max_nodes=2 * L, left_compact=0.0,
                        bitset_tx_threshold=0, pool_overlap=False)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    codes, lens = make_batch(reads, len(reads) + 5, L)  # padding rows
    ref = _MAP_JIT(meta, dev_np, codes.astype(np.int32), lens)
    idx, pmeta = port_index(dev_np, meta)
    packed = torch.from_numpy(ref_mk.pack_reads_host(codes).view(np.int32))
    lens_t = torch.from_numpy(lens)
    nh3 = mk.seed_tables(pmeta, idx, packed, lens_t)
    assert tuple(nh3.shape) == (len(lens), (P + 2) // 3, 3)
    assert pmeta.nh3_rows == (P + 2) // 3
    got = mk.map_batch_packed(pmeta, idx, packed, lens_t)
    assert_results_equal(ref, got, f"L={L}")
    assert np.asarray(ref.mapped).any()


@pytest.mark.parametrize("lazy", [True, False])
def test_nh3_counters(case, lazy):
    """The step counts each next-hit table it allocates and its bytes:
    B * ceil(P/3) * 12 a table under lazy seeds, B * P * 12 eager."""
    k, _, image, reads = case
    L = K_L[k]
    P = L - k + 1
    cfg = AlignerConfig(k=k, max_read_len=L, lazy_seeds=lazy,
                        pool_overlap=False)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    idx, pmeta = port_index(dev_np, meta)
    B = 96
    codes, lens = make_batch(reads, B, L)
    packed = torch.from_numpy(ref_mk.pack_reads_host(codes).view(np.int32))
    names = ("pa.seed.nh3_bytes", "pa.seed.tables")
    before = spans.snapshot()["counters"]
    for _ in range(2):
        mk.map_batch_packed(pmeta, idx, packed, torch.from_numpy(lens))
    after = spans.snapshot()["counters"]
    nbytes, tables = (after[n] - before.get(n, 0) for n in names)
    assert tables == 2
    assert nbytes / tables == B * ((P + 2) // 3 if lazy else P) * 12


def test_cuckoo_lookup_every_kmer(case):
    """Every k-mer of the index (the all-ones one included at k = 64) and
    as many random non-members, probed by both."""
    k, seqs, image, _ = case
    cfg = AlignerConfig(k=k, max_read_len=K_L[k], pool_overlap=False)
    dev_np, meta = ref_mk.device_index_from_image(image, cfg)
    keys = np.asarray(image.kmer_keys)
    rng = np.random.default_rng(k)
    noise = pack_kmers(rng.integers(0, 4, 4000).astype(np.uint8), k)
    queries = np.concatenate([keys, noise])
    rn, ro = ref_mk.cuckoo_lookup(meta, dev_np, jnp.asarray(queries))
    idx, pmeta = port_index(dev_np, meta)
    pn, po = mk.cuckoo_lookup(pmeta, idx,
                              torch.from_numpy(queries.astype(np.int64)))
    assert np.array_equal(pn.numpy(), np.asarray(rn))
    assert np.array_equal(po.numpy(), np.asarray(ro))
    # members resolve to their own (node, offset)
    n = len(keys)
    assert np.array_equal(pn.numpy()[:n], image.kmer_node.astype(np.int32))
    assert np.array_equal(po.numpy()[:n], image.kmer_offset.astype(np.int32))
    if k == 64:
        ones = np.all(keys == np.uint32(0xFFFFFFFF), axis=1)
        assert ones.sum() == 1 and pmeta.ones_node >= 0
