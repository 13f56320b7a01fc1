"""K-mer-partitioned index mode: a sharded lookup with all-to-all exchange.

Port of `pseudoaligner_tpu/parallel/sharded_index.py`, replicated-graph
half.  The k-mer index (per-shard sub-MPHFs with slot-ordered keys and
values, the largest part of the index at transcriptome scale) is
partitioned over the mesh by a hash of the k-mer; each shard holds one
sub-index and the graph is replicated.  Mapping a batch, per shard:

1. pack the shard's read codes on the device (`pack_reads_device`, K6
   csrc/pack.cu on a GPU);
2. route every valid position's k-mer to its owner shard, `hash & (S-1)`,
   into fixed-capacity send buffers at its stable rank among the queries
   of that owner (`route_queries`, K7 csrc/route.cu);
3. exchange the buffers (all_to_all), probe the local sub-MPHF and verify
   the stored key (`dynamic_verified_lookup`, K8 csrc/mphfdyn.cu);
4. exchange the results back and unscatter them into [b, P] seed tables
   (`unscatter_seeds`, K7); the next-hit table (K1's next_hit entry), the
   walk (K2) and, in the full-output shape, the bitset EC intersection (K4)
   and the counts (K9) then run as in the replicated engine.

Send buffers hold `cap = slack * b * P / S` queries per destination
(rounded up to 8, at least 64).  Queries past a full buffer are dropped
and counted (`overflow`); in the compact output their reads carry the -3
exact re-map marker, in the full output map_batch raises.  Every buffer
slot is probed, padding included, as the reference does: at S = 1 and
slack 4 that is four probes per query.

The graph-sharded mode (`shard_graph=True`: node rows and pool partitioned
by node blocks, one routed fetch per walk iteration) is not ported: it
puts an exchange inside every iteration of the walk, which K2 runs as one
loop inside the kernel.  See ROADMAP.md, queue A item 9.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config import AlignerConfig
from ..index.image import IndexImage
from ..index.mphf import build_mphf
from ..ops.hashing import hash_kmer, hash_kmer_np
from ..ops.kmers import all_kmers
from ..ops.map_kernel import (
    _as_i32,
    _as_tensor,
    device_index_from_image,
    lens_link_dtype,
    next_hit_table,
    pack_reads,
    unpack_reads,
    upload,
    walk_from_seeds,
)
from ..ops.mphf_lookup import dynamic_verified_lookup
from .mesh import concat_results, count_transcripts, gather_result, shard_batch

OWNER_SEED = 0xA5A5_5A5A


class ShardedLookup(NamedTuple):
    """Per-shard sub-index arrays.  From build_sharded_lookup: numpy,
    stacked, axis 0 the shard; from upload_lookup: one shard's int32
    tensors (uint32 as bit patterns), without that axis."""

    bits: object  # [S, max_bits_words] uint32
    ranks: object  # [S, max_bits_words] uint32
    seeds: object  # [S, n_levels] uint32
    masks: object  # [S, n_levels] uint32
    word_offsets: object  # [S, n_levels] int32
    key_offsets: object  # [S, n_levels] int32
    keys: object  # [S, max_keys, W] uint32
    values: object  # [S, max_keys, 2] int32 (node, offset)


@dataclass(frozen=True)
class KPartMeta:
    n_shards: int
    n_levels: int
    cap: int  # per-destination send capacity


def build_sharded_lookup(image: IndexImage, n_shards: int):
    """Partition the k-mer index by owner hash; build per-shard sub-MPHFs.
    -> (ShardedLookup of numpy arrays, n_levels)."""
    keys = image.kmer_keys
    owner = hash_kmer_np(keys, OWNER_SEED) & np.uint32(n_shards - 1)
    W = keys.shape[1]

    shard_data = []
    for s in range(n_shards):
        sel = np.nonzero(owner == s)[0]
        skeys = keys[sel]
        mphf, slot_of_key = build_mphf(skeys) if len(sel) else (None, None)
        values = np.zeros((max(1, len(sel)), 2), dtype=np.int32)
        ordered_keys = np.zeros((max(1, len(sel)), W), dtype=np.uint32)
        if len(sel):
            values[slot_of_key, 0] = image.kmer_node[sel].astype(np.int32)
            values[slot_of_key, 1] = image.kmer_offset[sel].astype(np.int32)
            ordered_keys[slot_of_key] = skeys
        shard_data.append((mphf, ordered_keys, values))

    n_levels = max(
        (m.n_levels for m, _, _ in shard_data if m is not None), default=1
    )
    max_keys = max(k.shape[0] for _, k, _ in shard_data)
    max_words = max(
        (len(m.bits) for m, _, _ in shard_data if m is not None), default=0
    ) + 1  # +1 zero word as the never-hit target for padded levels

    S = n_shards
    bits = np.zeros((S, max_words), dtype=np.uint32)
    ranks = np.zeros((S, max_words), dtype=np.uint32)
    seeds = np.zeros((S, n_levels), dtype=np.uint32)
    masks = np.zeros((S, n_levels), dtype=np.uint32)
    word_offsets = np.full((S, n_levels), max_words - 1, dtype=np.int32)
    key_offsets = np.zeros((S, n_levels), dtype=np.int32)
    keyarr = np.zeros((S, max_keys, W), dtype=np.uint32)
    valarr = np.zeros((S, max_keys, 2), dtype=np.int32)

    for s, (m, okeys, vals) in enumerate(shard_data):
        keyarr[s, : okeys.shape[0]] = okeys
        valarr[s, : vals.shape[0]] = vals
        if m is None:
            continue
        nl = m.n_levels
        bits[s, : len(m.bits)] = m.bits
        ranks[s, : len(m.ranks)] = m.ranks
        seeds[s, :nl] = m.seeds
        masks[s, :nl] = m.masks
        word_offsets[s, :nl] = m.word_offsets.astype(np.int32)
        key_offsets[s, :nl] = m.key_offsets.astype(np.int32)

    return (
        ShardedLookup(bits, ranks, seeds, masks, word_offsets, key_offsets,
                      keyarr, valarr),
        n_levels,
    )


def upload_lookup(lookup: ShardedLookup, shard: int, device) -> ShardedLookup:
    """Shard `shard`'s arrays of a numpy ShardedLookup as int32 tensors on
    `device`."""
    return ShardedLookup(*(_as_tensor(a[shard], device) for a in lookup))


def route_queries(packed: torch.Tensor, lens: torch.Tensor, k: int,
                  read_len: int, n_shards: int, cap: int):
    """Plain PyTorch routing of one shard's batch: packed reads
    [b, ceil(L/16)] int32, lens [b] -> (send_q [S, CAP, W] int32, send_src
    [S, CAP] int32 flat b*P + p source or -1, overflow [] int32, dropped
    [b] bool).

    Every valid position (p <= len - k) goes to owner hash & (S - 1) at its
    rank among that owner's queries in flat order: the reference's stable
    argsort by owner and searchsorted.  Invalid positions route nowhere:
    zero-padded tails all give the poly-A k-mer, which would pile onto one
    owner."""
    B = packed.shape[0]
    P = read_len - k + 1
    S = n_shards
    dev = packed.device
    flat = all_kmers(unpack_reads(packed, read_len), k).reshape(B * P, -1)
    n = B * P
    owner = hash_kmer(flat, OWNER_SEED) & (S - 1)
    pos = torch.arange(P, dtype=torch.int64, device=dev)
    valid = (pos[None, :] <= lens.to(torch.int64)[:, None] - k).reshape(n)
    owner = torch.where(valid, owner, S)
    order = torch.argsort(owner, stable=True)
    owner_sorted = owner[order]
    pos_in_bucket = torch.arange(n, device=dev) - torch.searchsorted(
        owner_sorted, owner_sorted, side="left")
    dropped_sorted = (pos_in_bucket >= cap) & (owner_sorted < S)
    overflow = dropped_sorted.sum().to(torch.int32)
    dropped_flat = torch.zeros(n, dtype=torch.bool, device=dev)
    dropped_flat[order] = dropped_sorted
    dropped = dropped_flat.reshape(B, P).any(dim=1)
    send_q = torch.zeros((S, cap, flat.shape[1]), dtype=torch.int32,
                         device=dev)
    send_src = torch.full((S, cap), -1, dtype=torch.int32, device=dev)
    ok = (pos_in_bucket < cap) & (owner_sorted < S)
    dst, slot, src = owner_sorted[ok], pos_in_bucket[ok], order[ok]
    send_q[dst, slot] = _as_i32(flat[src])
    send_src[dst, slot] = src.to(torch.int32)
    return send_q, send_src, overflow, dropped


def unscatter_seeds(back: torch.Tensor, src: torch.Tensor, B: int, P: int):
    """Plain PyTorch unscatter: returned pairs back [N, 2] int32 and their
    flat sources src [N] (-1 for unused slots) -> seed_node, seed_off
    [B, P] int32, -1 where nothing returned."""
    node = torch.full((B * P,), -1, dtype=torch.int32, device=back.device)
    off = node.clone()
    used = src >= 0
    at = src[used].to(torch.int64)
    node[at] = back[used, 0]
    off[at] = back[used, 1]
    return node.reshape(B, P), off.reshape(B, P)


def _route(meta, kmeta: KPartMeta, packed, lens):
    if packed.is_cuda:
        from ..ops.kernels import route_cuda

        return route_cuda(packed, lens, meta.k, meta.read_len,
                          kmeta.n_shards, kmeta.cap)
    return route_queries(packed, lens, meta.k, meta.read_len,
                         kmeta.n_shards, kmeta.cap)


def _probe(lookup: ShardedLookup, queries, n_levels: int):
    if queries.is_cuda:
        from ..ops.kernels import mphf_dynamic_cuda

        return mphf_dynamic_cuda(queries, lookup, n_levels)
    return dynamic_verified_lookup(queries, lookup, n_levels)


def _unscatter(back, src, B: int, P: int):
    if back.is_cuda:
        from ..ops.kernels import unscatter_cuda

        return unscatter_cuda(back, src, B, P)
    return unscatter_seeds(back, src, B, P)


def _next_hit(seed_node, seed_off, lens, k: int, P: int):
    if seed_node.is_cuda:
        from ..ops.kernels import next_hit_cuda

        return next_hit_cuda(seed_node, seed_off, lens, k)
    return next_hit_table(seed_node, seed_off, lens, k, P)


def _routed_seed_tables(meta, kmeta: KPartMeta, lookups: list,
                        packed: list, lens: list, mesh):
    """All-position seed tables through routed sub-index probes, for each
    shard this process holds (lookups, packed reads and int32 lens, one per
    local shard) -> [(seed_node [b, P], seed_off [b, P], overflow [],
    dropped [b])], overflow being the shard's own count."""
    S, CAP, P = kmeta.n_shards, kmeta.cap, meta.n_positions
    routed = [_route(meta, kmeta, pk, ln) for pk, ln in zip(packed, lens)]
    # received[s] = the queries shard s sent to this shard
    recv = mesh.all_to_all([r[0] for r in routed])
    res = [_probe(lk, rq.reshape(S * CAP, -1), kmeta.n_levels)
           .reshape(S, CAP, 2) for lk, rq in zip(lookups, recv)]
    back = mesh.all_to_all(res)
    out = []
    for (_q, src, overflow, dropped), bk, pk in zip(routed, back, packed):
        node, off = _unscatter(bk.reshape(S * CAP, 2), src.reshape(S * CAP),
                               pk.shape[0], P)
        out.append((node, off, overflow, dropped))
    return out


def make_kpart_step(meta, kmeta: KPartMeta, mesh, n_tx: int):
    """The k-mer-partitioned step: fn(idx, lookups, codes, lens) ->
    (results, counts, overflow), where lookups, codes [b, L] and lens hold
    one tensor (set) per local shard; results is one MapResult per local
    shard, counts [n_tx] int32 and overflow [] int32 sums over the mesh."""
    P = meta.n_positions

    def step(idx, lookups: list, codes: list, lens: list):
        lens = [n.to(torch.int32) for n in lens]
        packed = [pack_reads(c.to(torch.int32).contiguous()) for c in codes]
        seeds = _routed_seed_tables(meta, kmeta, lookups, packed, lens, mesh)
        results = []
        for pk, ln, (node, off, _over, dropped) in zip(packed, lens, seeds):
            nh3 = _next_hit(node, off, ln, meta.k, P)
            res = walk_from_seeds(meta, idx, pk, ln, nh3)
            if meta.distinct_cap > 0:
                # routing-overflow reads ride the compact -3 channel: the
                # host re-maps them exactly, so a rare full buffer costs a
                # few host re-maps instead of a batch error
                ecd = res.ec_distinct
                ecd[:, -1] = torch.where(dropped, -3, ecd[:, -1])
            results.append(res)
        if meta.tx_words > 0 and meta.distinct_cap == 0:
            # bitset counts exist only in the full-output shape; compact
            # serving counts on the host
            counts = mesh.all_reduce([count_transcripts(r.ec_bits, n_tx)
                                      for r in results])
        else:
            counts = torch.zeros(n_tx, dtype=torch.int32, device=mesh.device)
        overflow = mesh.all_reduce([s[2] for s in seeds])
        return results, counts, overflow

    return step


class KmerPartitionedAligner:
    """Mapping engine with the k-mer index sharded across the mesh and the
    graph replicated on every shard."""

    def __init__(
        self,
        image: IndexImage,
        config: AlignerConfig,
        mesh,
        slack: float = 4.0,
        shard_graph: bool = False,
    ):
        if shard_graph:
            raise NotImplementedError(
                "shard_graph=True (the graph-sharded walk, a routed fetch "
                "per iteration) is not ported yet: ROADMAP.md, queue A item "
                "9, next slice")
        self.mesh = mesh
        S = mesh.size
        if S & (S - 1):
            raise ValueError("mesh size must be a power of two")
        # the routed tables cover every position, so the walk needs no
        # seed index of its own: build the graph arrays under the MPHF
        # setting (no cuckoo table to build and drop) and turn lazy seeds
        # off (a lazy seek would probe the placeholder below).  Compact
        # outputs and walk caps pass through from the config: the -3 exact
        # re-map channel works per read as in the replicated engine.
        dev, meta = device_index_from_image(
            image, dataclasses.replace(config, seed_index="mphf"))
        meta = dataclasses.replace(meta, lazy_seeds=False)
        self.meta = meta
        self.config = config
        self.image = image  # host side: serving_aligner's emit and re-map
        self.n_tx = len(image.tx_names)

        lookup_np, n_levels = build_sharded_lookup(image, S)
        b_local = config.batch_size // S
        per_dev_queries = b_local * meta.n_positions
        cap = max(64, int(slack * per_dev_queries / S))
        cap = (cap + 7) // 8 * 8  # a multiple of 8
        self.kmeta = KPartMeta(n_shards=S, n_levels=n_levels, cap=cap)
        W = image.kmer_keys.shape[1]
        # the sharded lookup replaces the seed structures: placeholders
        graph = dataclasses.replace(
            dev,
            cuckoo=np.zeros((1, np.asarray(dev.cuckoo).shape[1]), np.uint32),
            cuckoo_vals=np.zeros(2, np.uint32),
            mphf_bits=np.zeros(1, np.uint32),
            mphf_ranks=np.zeros(1, np.uint32),
            kmer_keys=np.zeros((1, W), np.uint32),
            kmer_node=np.zeros(1, np.int32),
            kmer_offset=np.zeros(1, np.int32),
        )
        self.dev = upload(graph, mesh.device)
        self.lookups = [upload_lookup(lookup_np, r, mesh.device)
                        for r in mesh.ranks]
        self._step = make_kpart_step(meta, self.kmeta, mesh, self.n_tx)

    def serving_aligner(self):
        """A Pseudoaligner whose device step is this engine: the serving
        surface (emit_fastq, paired, count, tcc) over the partitioned
        index.  Each step gathers every shard's rows."""
        from ..models.aligner import Pseudoaligner

        return Pseudoaligner(
            self.image, self.config, device=self.mesh.device,
            map_step=lambda codes, lens: self.gather(
                self.map_batch(codes, lens)[0]),
            meta=self.meta,
        )

    def map_batch(self, reads: np.ndarray, lens: np.ndarray):
        """Map a global [B, L] batch of base codes (every process passes
        the same batch) -> (MapResult of this process's shards' rows,
        counts [n_tx] int32 summed over the mesh)."""
        nd = self.mesh.size
        if reads.shape[0] % nd:
            raise ValueError(
                f"batch {reads.shape[0]} not divisible by mesh size {nd}")
        ldt = lens_link_dtype(self.meta.read_len)
        codes, ln = shard_batch(np.asarray(reads).astype(np.int32),
                                np.asarray(lens).astype(ldt), self.mesh)
        results, counts, overflow = self._step(self.dev, self.lookups, codes,
                                               ln)
        if self.meta.distinct_cap == 0 and int(overflow) > 0:
            # the full output has no -3 channel; compact serving flags the
            # dropped reads -3 instead and never waits on this scalar
            raise RuntimeError(
                f"kpart routing overflow ({int(overflow)} queries): "
                "increase slack or re-run the batch through the replicated "
                "path")
        return concat_results(results), counts

    def gather(self, res):
        """Every shard's rows of a map_batch result."""
        return gather_result(self.mesh, res)
