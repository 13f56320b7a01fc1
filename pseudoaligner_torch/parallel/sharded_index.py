"""K-mer-partitioned index mode: a sharded lookup with all-to-all exchange.

Port of `pseudoaligner_tpu/parallel/sharded_index.py`.  The k-mer index
(per-shard sub-MPHFs with slot-ordered keys and values, the largest part
of the index at transcriptome scale) is partitioned over the mesh by a
hash of the k-mer; each shard holds one sub-index.  Mapping a batch, per
shard:

1. ship the shard's read codes over the host-to-device link at one byte
   a base (uint8, narrowed as the reference narrows them) and pack them
   on the device from that width (`pack_reads_device`, K6's uint8 entry,
   csrc/pack.cu, on a GPU);
2. route every valid position's k-mer to its owner shard, `hash & (S-1)`,
   into fixed-capacity send buffers at its stable rank among the queries
   of that owner (`route_queries`, K7 csrc/route.cu);
3. exchange the buffers (all_to_all), probe the local sub-MPHF and verify
   the stored key (`dynamic_verified_lookup`, K8 csrc/mphfdyn.cu);
4. exchange the results back and unscatter them into [b, P] seed tables
   (`unscatter_seeds`, K7) and build the next-hit table (K1's next_hit
   entry); then the walk:
   - with the graph replicated (the default), the walk (K2) and, in the
     full-output shape, the bitset EC intersection (K4) and the counts
     (K9), as in the replicated engine;
   - with `shard_graph=True`, the node rows and the 2-bit pool are split
     into S contiguous node blocks as well (`build_sharded_graph`), so a
     shard holds about 1/S of the whole index, and the walk fetches every
     node row and compare window from the node's owner, one all_to_all
     round trip per fetch (parallel/graph_walk.py, K10 csrc/gwalk.cu and
     K11 csrc/gfetch.cu).  Its full output intersects the class ids the
     walk pushed (K4's entry from class ids): the replicated node_row is a
     placeholder in this mode.

Send buffers hold `cap = slack * b * P / S` queries per destination
(rounded up to 8, at least 64).  Queries past a full buffer are dropped
and counted (`overflow`); in the compact output their reads carry the -3
exact re-map marker, in the full output map_batch raises.  Every buffer
slot gets the reference's result, padding included: the plain probe
probes each slot, as the reference does (at S = 1 and slack 4, four
probes per query); K8 probes the all-zero query, which every padded slot
holds, once per block that holds it and writes its result to every
all-zero slot.
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
    _pack_pool_rows,
    device_index_from_image,
    ec_bitset_intersect_classes,
    lens_link_dtype,
    next_hit_table,
    pack_reads,
    paired,
    paired_upload,
    record_upload,
    records,
    storage_nbytes,
    unpack_reads,
    upload,
    walk_from_seeds,
)
from ..ops.mphf_lookup import dynamic_verified_lookup
from .graph_walk import graph_walk
from .mesh import concat_results, count_transcripts, gather_result, shard_batch

OWNER_SEED = 0xA5A5_5A5A


class ShardedLookup(NamedTuple):
    """Per-shard sub-index arrays.  From build_sharded_lookup: numpy,
    stacked, axis 0 the shard; from upload_lookup: one shard's int32
    tensors (uint32 as bit patterns), without that axis, in K8's layouts:
    bits and ranks are the columns of one [max_bits_words, 2] tensor
    (`pairs`), keys and values column ranges of one [max_keys, RW] record
    tensor (`records`)."""

    bits: object  # [S, max_bits_words] uint32
    ranks: object  # [S, max_bits_words] uint32
    seeds: object  # [S, n_levels] uint32
    masks: object  # [S, n_levels] uint32
    word_offsets: object  # [S, n_levels] int32
    key_offsets: object  # [S, n_levels] int32
    keys: object  # [S, max_keys, W] uint32
    values: object  # [S, max_keys, 2] int32 (node, offset)

    @property
    def pairs(self) -> torch.Tensor:
        """An uploaded shard's [max_bits_words, 2] (bit word, rank word)
        tensor."""
        return paired(self.bits, self.ranks)

    @property
    def records(self) -> torch.Tensor:
        """An uploaded shard's [max_keys, RW] records: W key words, node,
        offset, zero padding (map_kernel.record_words); raises ValueError
        when keys and values are separate tensors."""
        if self.values.shape != (self.keys.shape[0], 2):
            raise ValueError("values must be [max_keys, 2] (node, offset) "
                             "beside the keys of one record tensor")
        return records(self.keys, self.values)

    def nbytes(self) -> int:
        """Bytes of an uploaded shard, each storage once."""
        return storage_nbytes(self)


@dataclass(frozen=True)
class KPartMeta:
    n_shards: int
    n_levels: int
    cap: int  # per-destination send capacity
    node_block: int = 0  # nodes per graph shard (0 = graph replicated)


class GraphShards(NamedTuple):
    """The graph partitioned by contiguous node-id blocks.  From
    build_sharded_graph: numpy, stacked, axis 0 the shard; from
    upload_graph: one shard's int32 tensors without that axis, the pool
    flattened to its words."""

    node_rows: object  # [S, Nb, 12] int32, start rebased to the block pool
    pools: object  # [S, Rmax, 8] uint32 2-bit block pools, zero padded


def build_sharded_graph(image: IndexImage, meta, n_shards: int):
    """Partition the node rows and the sequence pool into S contiguous
    node blocks -> (GraphShards of numpy arrays, Nb).

    Block s owns nodes [s*Nb, (s+1)*Nb), Nb = ceil(N/S), and the pool
    bases their sequences span, packed as the port's flat 2-bit pool with
    meta.pool_pad zero bases at both ends.  Node-row column 0 is rebased to
    start - (the block's first start) + pool_pad; columns 1-11 keep global
    node ids.  Shards past the last node (N < S) get a zero block.  The
    layout needs the pool to be the contiguous concatenation of the node
    sequences in node order, which both index builders emit."""
    N, S = image.n_nodes, n_shards
    Nb = (N + S - 1) // S
    starts = image.node_start.astype(np.int64)
    lens = image.node_len.astype(np.int64)
    # each block's slice [starts[lo], starts[hi-1] + lens[hi-1]) must cover
    # every member's span: nondecreasing starts alone would let an earlier
    # node run past the slice and read a truncated window.  A raise, not an
    # assert, so python -O keeps the check
    if not np.all(starts[1:] == starts[:-1] + lens[:-1]):
        raise ValueError("seq_pool must be the contiguous concatenation of "
                         "node sequences")
    pad = meta.pool_pad
    node_blocks, pool_blocks = [], []
    for s in range(S):
        lo, hi = s * Nb, min(N, (s + 1) * Nb)
        nr = np.zeros((Nb, 12), dtype=np.int32)
        if lo < hi:
            base, end = starts[lo], starts[hi - 1] + lens[hi - 1]
            pool_blocks.append(_pack_pool_rows(image.seq_pool[base:end], pad,
                                               pad))
            n = hi - lo
            nr[:n, 0] = (starts[lo:hi] - base + pad).astype(np.int32)
            nr[:n, 1] = image.node_len[lo:hi]
            nr[:n, 2] = image.node_exts[lo:hi]
            nr[:n, 3] = image.node_ec[lo:hi]
            nr[:n, 4:8] = image.r_edge[lo:hi]
            nr[:n, 8:12] = image.l_edge[lo:hi]
        else:
            pool_blocks.append(_pack_pool_rows(np.zeros(0, np.uint8), pad,
                                               pad))
        node_blocks.append(nr)
    pools = np.zeros((S, max(p.shape[0] for p in pool_blocks), 8),
                     dtype=np.uint32)
    for s, p in enumerate(pool_blocks):
        pools[s, : p.shape[0]] = p
    return GraphShards(np.stack(node_blocks), pools), Nb


def upload_graph(graph: GraphShards, shard: int, device) -> GraphShards:
    """Shard `shard`'s block of a numpy GraphShards as int32 tensors on
    `device`: node_rows [Nb, 12] and the flat pool words [Rmax * 8]."""
    return GraphShards(_as_tensor(graph.node_rows[shard], device),
                       _as_tensor(graph.pools[shard], device).reshape(-1))


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
    `device`, in the layouts K8 reads with one load each: the bit and rank
    words side by side (`pairs`), and each slot's key words, node and
    offset in one record (`records`, built on the device).  At W = 2 both
    take the bytes of the separate arrays; at W = 1, 3 and 4 a record's
    padding adds 4, 12 and 8 bytes per key."""
    (bits, ranks, seeds, masks, word_offsets, key_offsets, keys,
     values) = (a[shard] for a in lookup)
    W = keys.shape[1]
    rec = record_upload(keys, (values,), device)
    return ShardedLookup(
        *paired_upload(bits, ranks, device),
        *(_as_tensor(a, device)
          for a in (seeds, masks, word_offsets, key_offsets)),
        rec[:, :W], rec[:, W:W + 2])


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


def _intersect_classes(meta, idx, classes, res):
    if classes.is_cuda:
        from ..ops.kernels import ec_bits_classes_cuda

        return ec_bits_classes_cuda(meta, idx, classes, res.n_nodes,
                                    res.mapped)
    return ec_bitset_intersect_classes(meta, idx, classes, res.n_nodes,
                                       res.mapped)


def make_kpart_step(meta, kmeta: KPartMeta, mesh, n_tx: int):
    """The k-mer-partitioned step: fn(idx, lookups, codes, lens, graphs=None,
    stats=None, steps=None) -> (results, counts, overflow), where lookups,
    codes [b, L] (uint8 as they crossed the link, packed from that width)
    and lens hold one tensor (set) per local shard, and, with
    kmeta.node_block > 0, graphs one GraphShards block per local shard
    (upload_graph); results is one MapResult per local shard, counts
    [n_tx] int32 and overflow [] int32 sums over the mesh.  `stats`
    collects the graph-sharded walk's loop counts and `steps` overrides
    its step functions (graph_walk)."""
    P = meta.n_positions
    full_bits = meta.tx_words > 0 and meta.distinct_cap == 0

    def step(idx, lookups: list, codes: list, lens: list, graphs=None,
             stats=None, steps=None):
        lens = [n.to(torch.int32) for n in lens]
        packed = [pack_reads(c) for c in codes]
        seeds = _routed_seed_tables(meta, kmeta, lookups, packed, lens, mesh)
        nh3 = [_next_hit(node, off, ln, meta.k, P)
               for ln, (node, off, _over, _drop) in zip(lens, seeds)]
        if kmeta.node_block > 0:
            results = []
            for res, classes in graph_walk(meta, kmeta, graphs, packed, lens,
                                           nh3, mesh, steps, stats):
                if full_bits:
                    # the pushed class ids, never the placeholder node_row
                    bits = _intersect_classes(meta, idx, classes, res)
                    res = res._replace(ec_bits=bits.view(torch.uint32))
                results.append(res)
        else:
            results = [walk_from_seeds(meta, idx, pk, ln, nh)
                       for pk, ln, nh in zip(packed, lens, nh3)]
        if meta.distinct_cap > 0:
            # routing-overflow reads ride the compact -3 channel: the host
            # re-maps them exactly, so a rare full buffer costs a few host
            # re-maps instead of a batch error
            for res, (_node, _off, _over, dropped) in zip(results, seeds):
                ecd = res.ec_distinct
                ecd[:, -1] = torch.where(dropped, -3, ecd[:, -1])
        if full_bits:
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
    """Mapping engine with the k-mer index sharded across the mesh.

    shard_graph=True partitions the node rows and the sequence pool by
    contiguous node-id blocks too, one per shard: each shard then holds
    about 1/S of the whole index, at the cost of an all_to_all round trip
    per graph access of the walk (the mode for indexes beyond one card's
    memory).  shard_graph=False replicates the graph (fastest per card)."""

    def __init__(
        self,
        image: IndexImage,
        config: AlignerConfig,
        mesh,
        slack: float = 4.0,
        shard_graph: bool = False,
    ):
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
        node_block = 0
        graph_np = None
        if shard_graph:
            graph_np, node_block = build_sharded_graph(image, meta, S)
        self.kmeta = KPartMeta(n_shards=S, n_levels=n_levels, cap=cap,
                               node_block=node_block)
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
        if shard_graph:
            # the graph rides in the shards' blocks instead
            graph = dataclasses.replace(
                graph, pool_rows=np.zeros((1, 8), np.uint32),
                node_row=np.zeros((1, 12), np.int32))
        self.dev = upload(graph, mesh.device)
        self.lookups = [upload_lookup(lookup_np, r, mesh.device)
                        for r in mesh.ranks]
        self.graphs = (None if graph_np is None else
                       [upload_graph(graph_np, r, mesh.device)
                        for r in mesh.ranks])
        # the graph-sharded walk's loop counts, summed over map_batch calls,
        # and its step functions (None: graph_walk's default by device)
        self.walk_stats: dict = {}
        self.walk_steps = None
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

    def link_batch(self, reads: np.ndarray, lens: np.ndarray):
        """This process's shards' rows of a global [B, L] batch of base
        codes on the mesh's device, as they cross the link: codes at one
        byte a base (uint8, narrowed as the reference narrows them) and
        lens at lens_link_dtype's width -> ([codes of each local shard],
        [lens of each])."""
        ldt = lens_link_dtype(self.meta.read_len)
        return shard_batch(np.asarray(reads, dtype=np.uint8),
                           np.asarray(lens).astype(ldt), self.mesh)

    def map_batch(self, reads: np.ndarray, lens: np.ndarray):
        """Map a global [B, L] batch of base codes (every process passes
        the same batch) -> (MapResult of this process's shards' rows,
        counts [n_tx] int32 summed over the mesh)."""
        nd = self.mesh.size
        if reads.shape[0] % nd:
            raise ValueError(
                f"batch {reads.shape[0]} not divisible by mesh size {nd}")
        codes, ln = self.link_batch(reads, lens)
        results, counts, overflow = self._step(self.dev, self.lookups, codes,
                                               ln, self.graphs,
                                               self.walk_stats,
                                               self.walk_steps)
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
