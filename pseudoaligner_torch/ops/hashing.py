"""The 32-bit k-mer hash on tensors (plain PyTorch).

Bit-identical to `pseudoaligner_tpu.ops.hashing.hash_kmer_np`: murmur3's
fmix32 chained over the little-endian uint32 k-mer words from a seed.  The
host builds the cuckoo table with that hash, so the probe must agree bit
for bit.

torch's uint32 lacks shifts and compares on the CPU, so words and hashes
ride as int64 holding values in [0, 2**32).  Each 32x32-bit multiply is
split into two products below 2**48 so no int64 product overflows.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


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
