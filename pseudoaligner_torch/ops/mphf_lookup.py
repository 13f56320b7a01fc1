"""The MPHF seed probe on tensors (plain PyTorch).

Counterpart of `pseudoaligner_tpu/ops/mphf_lookup.py` (`mphf_probe`,
`verified_lookup`): the BBHash level probe of index/mphf.py (per level:
fmix32 hash with the level's seed, mask, bit word, rank word and the
popcount of the bits below) followed by a verify against the stored key at
the slot.  The first level whose bit is set gives the slot; an alien k-mer
may land on a set bit (a false positive), which the verify rejects.

Words, bits and ranks ride as int64 values in [0, 2**32) or int32 bit
patterns (see ops/hashing.py); slots come back as int64, -1 on a miss.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .hashing import MASK32, hash_kmer, popcount32


class MphfMeta(NamedTuple):
    """Per-level metadata of an index/mphf.py Mphf, as Python ints."""

    seeds: tuple[int, ...]
    masks: tuple[int, ...]
    word_offsets: tuple[int, ...]
    key_offsets: tuple[int, ...]

    @classmethod
    def of(cls, mphf) -> "MphfMeta":
        """From an Mphf (or anything with those four arrays)."""
        return cls(*(tuple(int(x) for x in getattr(mphf, f))
                     for f in cls._fields))


def mphf_probe(words: torch.Tensor, bits: torch.Tensor, ranks: torch.Tensor,
               meta: MphfMeta) -> torch.Tensor:
    """[..., W] k-mer words -> [...] int64 candidate slot, -1 when no
    level's bit is set.  The reference adds the rank in int32; slots stay
    below 2**31 for any index a card holds, so int64 gives the same."""
    out = torch.full(words.shape[:-1], -1, dtype=torch.int64,
                     device=words.device)
    for lv in range(len(meta.seeds)):
        h = hash_kmer(words, meta.seeds[lv]) & meta.masks[lv]
        w = meta.word_offsets[lv] + (h >> 5)
        word = bits[w].to(torch.int64) & MASK32
        bitpos = h & 31
        bit = (word >> bitpos) & 1
        below = word & ((torch.ones_like(bitpos) << bitpos) - 1)
        rank = (ranks[w].to(torch.int64) & MASK32) + popcount32(below)
        hit = (out < 0) & (bit == 1)
        out = torch.where(hit, meta.key_offsets[lv] + rank, out)
    return out


def verified_lookup(words: torch.Tensor, bits: torch.Tensor,
                    ranks: torch.Tensor, meta: MphfMeta,
                    kmer_keys: torch.Tensor, kmer_node: torch.Tensor,
                    kmer_offset: torch.Tensor):
    """Exact lookup: [..., W] words -> (node, offset) int32, -1 on a miss
    or a false positive.  kmer_keys [n, W] (int32 bit patterns) and the
    values are in slot order."""
    slot, ok = probe_and_verify(words, bits, ranks, meta, kmer_keys)
    safe = slot.clamp(min=0)
    node = torch.where(ok, kmer_node[safe], -1)
    off = torch.where(ok, kmer_offset[safe], -1)
    return node.to(torch.int32), off.to(torch.int32)


def probe_and_verify(words, bits, ranks, meta: MphfMeta, kmer_keys):
    """(slot, verified): the probe's slot and whether the key stored there
    equals the query."""
    slot = mphf_probe(words, bits, ranks, meta)
    stored = kmer_keys[slot.clamp(min=0)].to(torch.int64) & MASK32
    ok = (slot >= 0) & (stored == (words.to(torch.int64) & MASK32)).all(-1)
    return slot, ok
