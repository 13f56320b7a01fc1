"""PyTorch port vs the JAX reference: cuckoo probe and the next-hit table
(the plain PyTorch side of the seed kernel K1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.dna import pack_kmers
from pseudoaligner_tpu.ops import map_kernel as ref_mk
from pseudoaligner_torch.ops import map_kernel as mk

from .torch_helpers import (
    _fuzz_reads,
    build,
    make_batch,
    polyt_transcripts,
    port_index,
)

K_L = {20: 64, 64: 96}


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
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert np.array_equal(got.numpy(), ref)
    # the table really holds hits, and lazy mode leaves residues 1, 2 empty
    assert (ref[:, :, 0] < meta.n_positions).any()
    if lazy:
        assert (ref[:, 1::3, 0] == meta.n_positions).all()


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
