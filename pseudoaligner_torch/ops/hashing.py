"""The 32-bit k-mer hash: the host's NumPy form and the tensors' form.

murmur3's fmix32 chained over the little-endian uint32 k-mer words from a
seed.  The host builds the cuckoo, bucket1 and MPHF tables with
`hash_kmer_np`; the probes (`hash_kmer` here, `hash_words` in
csrc/common.cuh) must agree with it bit for bit.

torch's uint32 lacks shifts and compares on the CPU, so words and hashes
ride as int64 holding values in [0, 2**32).  Each 32x32-bit multiply is
split into two products below 2**48 so no int64 product overflows.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dna import _mix32

MASK32 = 0xFFFFFFFF
GOLDEN32 = 0x9E3779B9


# --- host (NumPy) ----------------------------------------------------------


def mix32_np(h: np.ndarray) -> np.ndarray:
    # ONE NumPy fmix32 for the whole framework: dna._mix32 is the
    # implementation (hashn N-substitution and the MPHF must stay
    # bit-identical — review r5: two copies only ASKED to stay in sync)
    return _mix32(np.asarray(h))


def hash_kmer_np(words: np.ndarray, seed: int) -> np.ndarray:
    """[..., W] uint32 words -> [...] uint32 hash."""
    words = np.asarray(words, dtype=np.uint32)
    h = np.full(words.shape[:-1], np.uint32(seed), dtype=np.uint32)
    for j in range(words.shape[-1]):
        h = mix32_np(h ^ words[..., j])
    return h


def level_seed(level: int) -> int:
    """Per-MPHF-level seed; any fixed injective-ish map works."""
    return int(mix32_np(np.uint32((level + 1) * GOLDEN32 & 0xFFFFFFFF))[()])


# --- tensors (plain PyTorch, bit-identical) --------------------------------


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for h in [0, 2**32), without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding uint32 values."""
    h = h & MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_kmer(words: torch.Tensor, seed: int) -> torch.Tensor:
    """[..., W] k-mer words (any integer dtype; int32 is read as its
    uint32 bit pattern) -> [...] int64 hash in [0, 2**32)."""
    w = words.to(torch.int64) & MASK32
    h = torch.full(w.shape[:-1], seed & MASK32, dtype=torch.int64,
                   device=w.device)
    for j in range(w.shape[-1]):
        h = mix32(h ^ w[..., j])
    return h


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2**32) (SWAR; the byte sums never
    carry, so the int64 product needs no wrap)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF
