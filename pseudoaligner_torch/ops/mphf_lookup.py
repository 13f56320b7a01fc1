"""The MPHF seed probe on tensors (plain PyTorch).

Counterpart of `pseudoaligner_tpu/ops/mphf_lookup.py` (`mphf_probe`,
`verified_lookup`): the BBHash level probe of index/mphf.py (per level:
fmix32 hash with the level's seed, mask, bit word, rank word and the
popcount of the bits below) followed by a verify against the stored key at
the slot.  The first level whose bit is set gives the slot; an alien k-mer
may land on a set bit (a false positive), which the verify rejects.
`mphf_probe_dynamic` and `dynamic_verified_lookup` are the same probe with
the level table in tensors, one per shard of the k-mer-partitioned index
(csrc/mphfdyn.cu on a GPU).

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


def mphf_probe_dynamic(words: torch.Tensor, bits: torch.Tensor,
                       ranks: torch.Tensor, seeds: torch.Tensor,
                       masks: torch.Tensor, word_offsets: torch.Tensor,
                       key_offsets: torch.Tensor,
                       n_levels: int) -> torch.Tensor:
    """The probe with its level table in tensors (one shard's sub-MPHF of
    the k-mer-partitioned index, parallel/sharded_index.py) -> [...] int32
    slot, -1 when no level's bit is set.  Levels padded past the shard's
    own have mask 0 and point at a zero word, so they never hit.  Plain
    PyTorch: the table is read to the host and probed as mphf_probe."""
    meta = MphfMeta(*(tuple(int(x) & MASK32 for x in t[:n_levels].tolist())
                      for t in (seeds, masks, word_offsets, key_offsets)))
    return mphf_probe(words, bits, ranks, meta).to(torch.int32)


def dynamic_verified_lookup(queries: torch.Tensor, lookup,
                            n_levels: int) -> torch.Tensor:
    """Plain PyTorch shard-local lookup of the k-mer-partitioned step:
    queries [N, W] against one shard's sub-index `lookup` (a ShardedLookup
    of that shard's tensors) -> [N, 2] int32 (node, offset), -1 where the
    probe misses or the key stored at its slot differs."""
    slot = mphf_probe_dynamic(queries, lookup.bits, lookup.ranks,
                              lookup.seeds, lookup.masks,
                              lookup.word_offsets, lookup.key_offsets,
                              n_levels).to(torch.int64)
    safe = slot.clamp(min=0)
    stored = lookup.keys[safe].to(torch.int64) & MASK32
    ok = (slot >= 0) & (stored == (queries.to(torch.int64) & MASK32)).all(-1)
    vals = lookup.values[safe]
    return torch.where(ok[:, None], vals, -1).to(torch.int32)
