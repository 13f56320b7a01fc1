"""PyTorch port vs the JAX reference: hashing, k-mer words, read unpack.

All comparisons are exact (integer outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudoaligner_tpu.index.cuckoo import H1_SEED, H2_SEED
from pseudoaligner_tpu.ops.hashing import hash_kmer_jnp, hash_kmer_np
from pseudoaligner_tpu.ops.kmers import all_kmers as all_kmers_jax
from pseudoaligner_tpu.ops.map_kernel import (
    pack_reads_host,
    unpack_reads as unpack_reads_jax,
)
from pseudoaligner_torch.ops.hashing import hash_kmer, mix32
from pseudoaligner_torch.ops.kmers import all_kmers
from pseudoaligner_torch.ops.map_kernel import unpack_reads


def _words(rng, n, W):
    """uint32 words, a quarter of them with the top bit forced on, plus
    the all-ones and zero words."""
    w = rng.integers(0, 2**32, size=(n, W), dtype=np.uint64).astype(np.uint32)
    w[: n // 4] |= np.uint32(0x80000000)
    w[-1] = 0xFFFFFFFF
    w[-2] = 0
    return w


@pytest.mark.parametrize("seed", [H1_SEED, H2_SEED])
@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_hash_kmer_matches_reference(W, seed):
    w = _words(np.random.default_rng(W), 4096, W)
    want = hash_kmer_np(w, seed)
    assert np.array_equal(np.asarray(hash_kmer_jnp(jnp.asarray(w), seed)),
                          want)
    # the port takes int64 uint32 values or int32 bit patterns alike
    got64 = hash_kmer(torch.from_numpy(w.astype(np.int64)), seed)
    got32 = hash_kmer(torch.from_numpy(w.view(np.int32)), seed)
    assert got64.dtype == torch.int64
    assert np.array_equal(got64.numpy(), want.astype(np.int64))
    assert np.array_equal(got32.numpy(), want.astype(np.int64))


def test_mix32_top_bit_values():
    """Pins the int64 representation: products of top-bit words with the
    fmix32 constants exceed 2**63 if multiplied whole."""
    from pseudoaligner_tpu.ops.hashing import mix32_np

    h = np.array([0x80000000, 0xFFFFFFFF, 0xDEADBEEF, 0x85EBCA6B, 1, 0],
                 dtype=np.uint32)
    got = mix32(torch.from_numpy(h.astype(np.int64)))
    assert np.array_equal(got.numpy(), mix32_np(h).astype(np.int64))
    assert int(got.min()) >= 0 and int(got.max()) < 2**32


@pytest.mark.parametrize("k,L", [(20, 64), (64, 96)])
def test_all_kmers_and_unpack_match_reference(k, L):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, size=(64, L)).astype(np.uint8)
    codes[0] = 3  # all-ones k-mer words at k = 64
    packed = pack_reads_host(codes)
    ref_codes = np.asarray(unpack_reads_jax(jnp.asarray(packed), L))
    got_codes = unpack_reads(torch.from_numpy(packed.view(np.int32)), L)
    assert got_codes.dtype == torch.int32
    assert np.array_equal(got_codes.numpy(), ref_codes)
    assert np.array_equal(ref_codes, codes)

    ref = np.asarray(all_kmers_jax(jnp.asarray(codes.astype(np.int32)), k))
    got = all_kmers(got_codes, k)
    assert got.shape == ref.shape
    assert np.array_equal(got.numpy(), ref.astype(np.int64))


def test_all_kmers_rejects_short_width():
    with pytest.raises(ValueError):
        all_kmers(torch.zeros((2, 10), dtype=torch.int32), 20)
