"""The batched read-mapping step: device index, seed pass and graph walk.

Port of `pseudoaligner_tpu/ops/map_kernel.py` for the single-end serving
path.  One batch of 2-bit packed reads goes through two passes:

- the seed pass (`seed_tables`): every probed read position's k-mer is
  looked up in the two-bucket, 4-slot cuckoo table, and a stride-3
  next-hit table `nh3 [B, P, 3]` gives, for each position p, the nearest
  hit q >= p on p's residue grid with its (node, offset);
- the walk (`walk`): per read, left extension under the per-segment SNP
  budget, then the forward unitig walk with re-seeds from `nh3` (or lazy
  seek probes off the residue-0 grid), iteration caps, and the compact
  run-length EC-id output (or the full node list when distinct_cap = 0).

`map_batch_packed` runs the CUDA kernels (ops/kernels.py, csrc/seed.cu and
csrc/walk.cu) for CUDA tensors and the plain PyTorch passes below for CPU
tensors.  The plain passes are batched, masked tensor code written from the
reference's semantics, independent of the CUDA sources; tests hold them
equal to the JAX reference and chip_smoke.py holds the kernels equal to
them on the card.

TPU-only knobs of AlignerConfig are read and ignored here: pool_overlap /
pool_stride, walk_unroll, walk_straightline, left_compact, walk_split /
walk_compact and seed_compact.  The port always uses the plain,
non-overlapping 2-bit pool with meta.pool_pad front padding and no lane
compaction: each read's walk runs to its own iteration caps.  The
reference's left_compact capacity overflow (-3 on lanes beyond the
compacted buffer) therefore has no counterpart; those reads come out of the
port with their exact result, and emitted records are identical because
the reference re-maps its -3 reads exactly on the host.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch

from pseudoaligner_tpu import dna
from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.index.cuckoo import (
    EMPTY as CK_EMPTY,
    H1_SEED,
    H2_SEED,
    SLOTS as CK_SLOTS,
    build_cuckoo_fast,
)

from .hashing import MASK32, hash_kmer
from .kmers import all_kmers

# what loading one of pseudoaligner_tpu's native host helpers raises when
# its toolchain or library is unavailable (they compile on first use)
NATIVE_ERRORS = (ImportError, OSError, subprocess.CalledProcessError)


@dataclass
class DeviceIndex:
    """The device-resident index arrays.

    `device_index_from_image` returns them as numpy uint32/int32 arrays
    (equal, array for array, to the reference's at pool_overlap=False);
    `upload` turns them into int32 tensors on a device, uint32 arrays
    carried as their int32 bit patterns."""

    pool_rows: object  # [R, 8] 2-bit packed pool, 128 bases/row, with
    #                    meta.pool_pad zero bases at both ends
    node_row: object  # [N, 12] start(+pad), len, exts, ec, r_edge[4],
    #                   l_edge[4]
    cuckoo: object  # [NB, SLOTS*W] keys-only bucket rows; empty slots hold
    #                 all-ones keys (a real all-ones k-mer lives in meta)
    cuckoo_vals: object  # [NB*SLOTS*2] flat (node, offset) slot values

    def nbytes(self) -> int:
        """Bytes of an uploaded index (tensors)."""
        return sum(getattr(self, f.name).numel()
                   * getattr(self, f.name).element_size()
                   for f in fields(self))


@dataclass(frozen=True)
class MapMeta:
    """Static mapping parameters (the reference MapMeta's fields that the
    port reads)."""

    k: int
    read_len: int  # L, the padded batch width
    allowed_mismatches: int
    left_extend_fraction: float
    max_nodes: int
    cuckoo_mask: int
    # the all-ones k-mer's payload when it is a real key (2k == 32W only):
    # empty cuckoo slots hold the all-ones key pattern
    ones_node: int = -1
    ones_off: int = -1
    pool_pad: int = 256
    distinct_cap: int = 0  # compact EC-id output slots; 0 = full output
    lazy_seeds: bool = False  # probe only residue-0 positions up front
    max_walk_iters: int = 0  # 0 = unbounded
    max_left_iters: int = 0  # 0 = unbounded
    ec_out_16: bool = False  # compact EC ids as int16
    cov_out_8: bool = False  # compact coverage as uint8

    @property
    def n_positions(self) -> int:
        return self.read_len - self.k + 1

    @property
    def kmer_words(self) -> int:
        return dna.kmer_words(self.k)


class MapResult(NamedTuple):
    """Per-read outputs of one mapping step (the reference's fields).

    Compact mode (distinct_cap > 0): `ec_distinct [B, DC]` holds each
    read's run-compacted EC ids, -1 padded; the last slot is -2 when more
    than DC runs were visited and -3 when a cap cut the walk (both mean:
    re-map this read exactly).  Full mode: `nodes [B, max_nodes]`."""

    mapped: torch.Tensor  # [B] bool
    coverage: torch.Tensor  # [B] int32 (uint8 when meta.cov_out_8)
    mismatches: torch.Tensor  # [B] int32
    nodes: torch.Tensor  # [B, max_nodes] int32, or [B, 0] in compact mode
    n_nodes: torch.Tensor  # [B] int32, all pushes (may exceed max_nodes)
    ec_bits: torch.Tensor  # [B, 0] uint32 (the bitset EC path is not ported)
    ec_distinct: torch.Tensor  # [B, DC] int32/int16, or [B, 0]


# ---------------------------------------------------------------------------
# image -> device index
# ---------------------------------------------------------------------------


def pack_reads_host(codes: np.ndarray) -> np.ndarray:
    """[B, L] uint8 codes -> [B, ceil(L/16)] uint32, 16 bases per word,
    base i at bits 2*(i % 16) (C++ packer, NumPy fallback)."""
    try:
        from pseudoaligner_tpu.io.native import pack_reads

        return pack_reads(np.asarray(codes, dtype=np.uint8))
    except NATIVE_ERRORS:
        pass
    B, L = codes.shape
    nw = (L + 15) // 16
    padded = np.zeros((B, nw * 16), dtype=np.uint32)
    padded[:, :L] = codes
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    return np.bitwise_or.reduce(padded.reshape(B, nw, 16) << shifts,
                                axis=2).astype(np.uint32)


def _pack_pool_rows(seq_pool: np.ndarray, pad_front: int,
                    pad_back: int) -> np.ndarray:
    """uint8 base codes -> [R, 8] uint32 rows (128 bases/row), zero padded
    (the reference's layout at pool_stride = 0)."""
    total = pad_front + len(seq_pool) + pad_back
    total = (total + 127) // 128 * 128
    codes = np.zeros(total, dtype=np.uint8)
    codes[pad_front : pad_front + len(seq_pool)] = seq_pool
    return dna.pack_codes_2bit(codes).reshape(-1, 8)


def _pool_pad(max_read_len: int) -> int:
    """Zero bases at each end of the pool: at least one read length, so
    no compare window of a node leaves the pool (the reference's
    `_derived_knobs` pool_pad)."""
    return ((max_read_len + 127) // 128 + 1) * 128


def device_index_from_image(image, config: AlignerConfig):
    """IndexImage -> (DeviceIndex of numpy arrays, MapMeta).

    Cuckoo seed index only.  Builds the same arrays as the reference's
    `device_index_from_image` at pool_overlap=False; the reference's
    on-disk devcache is neither read nor written."""
    if config.seed_index != "cuckoo":
        raise NotImplementedError(
            f"seed_index={config.seed_index!r} is not ported; use 'cuckoo'")
    pool_pad = _pool_pad(config.max_read_len)
    W = image.kmer_keys.shape[1]
    pool_rows = _pack_pool_rows(image.seq_pool, pool_pad, pool_pad)

    node_row = np.zeros((image.n_nodes, 12), dtype=np.int32)
    node_row[:, 0] = image.node_start.astype(np.int64) + pool_pad
    node_row[:, 1] = image.node_len
    node_row[:, 2] = image.node_exts
    node_row[:, 3] = image.node_ec
    node_row[:, 4:8] = image.r_edge
    node_row[:, 8:12] = image.l_edge

    ck = build_cuckoo_fast(image.kmer_keys, image.kmer_node,
                           image.kmer_offset)
    nb = ck.buckets.shape[0]
    full = ck.buckets.reshape(nb, CK_SLOTS, W + 2)
    keys = full[:, :, :W].copy()
    keys[full[:, :, W] == CK_EMPTY] = 0xFFFFFFFF
    cuckoo = np.ascontiguousarray(keys.reshape(nb, CK_SLOTS * W))
    cuckoo_vals = np.ascontiguousarray(full[:, :, W : W + 2].reshape(-1))
    ones_node = ones_off = -1
    if image.k * 2 == 32 * W:
        # the all-ones k-mer is real at word-filling k and collides with
        # the empty-slot key pattern: its payload rides in meta
        hit = np.all(image.kmer_keys == np.uint32(0xFFFFFFFF),
                     axis=1).nonzero()[0]
        if len(hit):
            ones_node = int(image.kmer_node[hit[0]])
            ones_off = int(image.kmer_offset[hit[0]])

    dev = DeviceIndex(pool_rows=pool_rows, node_row=node_row, cuckoo=cuckoo,
                      cuckoo_vals=cuckoo_vals)
    meta = _make_meta(image, config, ck.mask, ones_node, ones_off, pool_pad)
    return dev, meta


def _make_meta(image, config: AlignerConfig, cuckoo_mask: int,
               ones_node: int, ones_off: int, pool_pad: int) -> MapMeta:
    compact = config.distinct_cap > 0
    return MapMeta(
        k=image.k,
        read_len=config.max_read_len,
        allowed_mismatches=config.allowed_mismatches,
        left_extend_fraction=config.left_extend_fraction,
        max_nodes=config.max_nodes,
        cuckoo_mask=cuckoo_mask,
        ones_node=ones_node,
        ones_off=ones_off,
        pool_pad=pool_pad,
        distinct_cap=config.distinct_cap,
        lazy_seeds=config.lazy_seeds,
        # the caps need the compact -3 marker channel for exact re-maps
        max_walk_iters=config.max_walk_iters if compact else 0,
        max_left_iters=config.max_left_iters if compact else 0,
        ec_out_16=compact and image.n_ecs < 2**15 - 4,
        cov_out_8=compact and config.max_read_len <= 255,
    )


def from_jax_device_index(dev_np, meta) -> tuple[DeviceIndex, MapMeta]:
    """The reference's numpy DeviceIndex and MapMeta -> the port's, so
    both engines compute on the same arrays.  Needs the reference's
    cuckoo seed index and non-overlapping pool (pool_stride = 0); its
    bitset fields (tx_words, ec_bits) have no counterpart here."""
    if meta.seed_index != "cuckoo" or meta.pool_stride != 0:
        raise ValueError("need seed_index='cuckoo' and pool_stride=0, got "
                         f"{meta.seed_index!r}, {meta.pool_stride}")
    dev = DeviceIndex(
        pool_rows=np.asarray(dev_np.pool_rows),
        node_row=np.asarray(dev_np.node_row),
        cuckoo=np.asarray(dev_np.cuckoo),
        cuckoo_vals=np.asarray(dev_np.cuckoo_vals),
    )
    port = MapMeta(**{f.name: getattr(meta, f.name) for f in fields(MapMeta)})
    return dev, port


def _as_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32/int32 array -> int32 tensor (uint32 as bit pattern)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


def upload(dev: DeviceIndex, device) -> DeviceIndex:
    """Move a numpy DeviceIndex to `device` as int32 tensors."""
    return DeviceIndex(**{f.name: _as_tensor(getattr(dev, f.name), device)
                          for f in fields(DeviceIndex)})


# ---------------------------------------------------------------------------
# the seed pass (plain PyTorch)
# ---------------------------------------------------------------------------


def unpack_reads(packed: torch.Tensor, L: int) -> torch.Tensor:
    """[B, ceil(L/16)] int32 2-bit-packed reads -> [B, L] int32 codes."""
    B, nw = packed.shape
    shifts = torch.arange(16, dtype=torch.int32, device=packed.device) * 2
    codes = (packed[:, :, None] >> shifts) & 3
    return codes.reshape(B, nw * 16)[:, :L]


def _as_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> their int32 bit patterns."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def cuckoo_lookup(meta: MapMeta, idx: DeviceIndex, words: torch.Tensor):
    """[..., W] int64 k-mer words -> (node, offset) int32, -1 on miss.

    Two candidate buckets, four slots each; the first key match in
    (bucket, slot) order wins.  At 2k == 32W the all-ones k-mer resolves
    from meta.ones_node/ones_off (its key pattern marks empty slots)."""
    W = words.shape[-1]
    keys = _as_i32(words)
    found = torch.zeros(words.shape[:-1], dtype=torch.bool,
                        device=words.device)
    vidx = torch.zeros(words.shape[:-1], dtype=torch.int64,
                       device=words.device)
    for seed in (H1_SEED, H2_SEED):
        h = hash_kmer(words, seed) & meta.cuckoo_mask
        rows = idx.cuckoo[h]  # [..., SLOTS*W]
        for s in range(CK_SLOTS):
            keym = (rows[..., s * W : (s + 1) * W] == keys).all(dim=-1)
            vidx = torch.where(keym & ~found, h * CK_SLOTS + s, vidx)
            found = found | keym
    node = torch.where(found, idx.cuckoo_vals[2 * vidx], -1)
    off = torch.where(found, idx.cuckoo_vals[2 * vidx + 1], -1)
    if 2 * meta.k == 32 * W:
        ones = (words == MASK32).all(dim=-1)
        node = torch.where(ones, meta.ones_node, node)
        off = torch.where(ones, meta.ones_off, off)
    return node.to(torch.int32), off.to(torch.int32)


def next_hit_table(seed_node, seed_off, lens, k: int, P: int):
    """Mask invalid positions, then per stride-3 residue a suffix min
    (flipped cummin) of the valid positions: nh3[b, p] = (q, node@q,
    off@q) for the nearest valid q >= p on p's residue grid, (P, -1, -1)
    when there is none."""
    B = seed_node.shape[0]
    dev = seed_node.device
    pos = torch.arange(P, dtype=torch.int64, device=dev)
    valid = (seed_node >= 0) & (pos[None, :]
                                <= lens.to(torch.int64)[:, None] - k)
    node = torch.where(valid, seed_node, -1)
    off = torch.where(valid, seed_off, -1)
    cand = torch.where(valid, pos[None, :], P)
    nh3 = torch.empty((B, P, 3), dtype=torch.int32, device=dev)
    for r in range(min(3, P)):
        c = cand[:, r::3]
        q = torch.flip(torch.cummin(torch.flip(c, [1]), dim=1).values, [1])
        qi = q.clamp(max=P - 1)
        nh3[:, r::3, 0] = q.to(torch.int32)
        nh3[:, r::3, 1] = torch.where(q < P, node.gather(1, qi), -1)
        nh3[:, r::3, 2] = torch.where(q < P, off.gather(1, qi), -1)
    return nh3


def seed_tables(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
                lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch seed pass: packed reads -> nh3 [B, P, 3] int32.

    With meta.lazy_seeds only residue-0 positions are probed; residues 1
    and 2 stay all (P, -1, -1) and the walk probes them lazily."""
    P = meta.n_positions
    reads = unpack_reads(packed, meta.read_len)
    kmers = all_kmers(reads, meta.k)
    if meta.lazy_seeds:
        n3, o3 = cuckoo_lookup(meta, idx, kmers[:, ::3])
        node = torch.full((reads.shape[0], P), -1, dtype=torch.int32,
                          device=reads.device)
        off = node.clone()
        node[:, ::3] = n3
        off[:, ::3] = o3
    else:
        node, off = cuckoo_lookup(meta, idx, kmers)
    return next_hit_table(node, off, lens, meta.k, P)


# ---------------------------------------------------------------------------
# the walk (plain PyTorch, lockstep over the batch)
# ---------------------------------------------------------------------------


class _WalkCtx:
    """Per-batch tensors and helpers shared by the walk's two loops."""

    def __init__(self, meta: MapMeta, idx: DeviceIndex, packed, lens):
        self.meta = meta
        self.idx = idx
        L = meta.read_len
        self.reads = unpack_reads(packed, L).to(torch.int64)  # [B, L]
        self.lens = lens.to(torch.int64)
        self.dev = packed.device
        self.rows = torch.arange(packed.shape[0], device=self.dev)
        self.j = torch.arange(L, dtype=torch.int64, device=self.dev)
        self.pool = idx.pool_rows.reshape(-1).to(torch.int64)
        self.pool_bases = self.pool.numel() * 16

    def read_window(self, start, step):
        """[B, L] read bases at start + step*j (0 outside the read row)."""
        L = self.meta.read_len
        p = start[:, None] + step * self.j[None, :]
        got = self.reads.gather(1, p.clamp(0, L - 1))
        return torch.where((p >= 0) & (p < L), got, 0)

    def pool_window(self, start, step):
        """[B, L] pool bases at absolute padded-pool positions
        start + step*j (positions outside the pool are clamped: they lie
        beyond every compare range)."""
        p = (start[:, None] + step * self.j[None, :]).clamp(
            0, self.pool_bases - 1)
        return (self.pool[p >> 4] >> ((p & 15) * 2)) & 3

    def segment(self, mismatch, maxm):
        """Per-segment SNP budget over the first maxm compared bases ->
        (matched, mm_add, premature).  The base that breaks the budget
        counts as a mismatch but not as matched."""
        allowed = self.meta.allowed_mismatches
        in_range = self.j[None, :] < maxm[:, None]
        c = torch.cumsum((mismatch & in_range).to(torch.int64), dim=1)
        total = c[:, -1]
        prem = total > allowed
        matched = torch.where(prem, ((c <= allowed) & in_range).sum(1), maxm)
        mm_add = torch.where(prem, allowed + 1, total)
        return matched, mm_add, prem

    def kmer_at(self, reads, pos):
        """[n, L] reads, [n] positions -> [n, W] int64 k-mer words."""
        k = self.meta.k
        codes = reads.gather(
            1, pos[:, None] + torch.arange(k, device=self.dev)[None, :])
        words = torch.zeros((reads.shape[0], self.meta.kmer_words),
                            dtype=torch.int64, device=self.dev)
        for i in range(k):
            bitpos = 2 * (k - 1 - i)
            words[:, bitpos // 32] |= codes[:, i] << (bitpos % 32)
        return words


def _push(buf, n_nodes, node, ec, do):
    """Append (node, ec) for lanes `do`; only the first max_nodes pushes
    are stored, n_nodes counts all of them.  Updates buf in place."""
    r = (do & (n_nodes < buf.shape[1])).nonzero(as_tuple=True)[0]
    slot = n_nodes[r]
    buf[r, slot, 0] = node[r].to(torch.int32)
    buf[r, slot, 1] = ec[r].to(torch.int32)
    return n_nodes + do.to(torch.int64)


def walk(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
         lens: torch.Tensor, nh3: torch.Tensor) -> MapResult:
    """Plain PyTorch walk: left extension, forward walk, output encoding."""
    ctx = _WalkCtx(meta, idx, packed, lens)
    B = packed.shape[0]
    k, P, M = meta.k, meta.n_positions, meta.max_nodes
    dev = ctx.dev
    lens64 = ctx.lens
    node_row = idx.node_row.to(torch.int64)

    q0 = nh3[:, 0, 0].to(torch.int64)
    node0 = nh3[:, 0, 1].to(torch.int64)
    off0 = nh3[:, 0, 2].to(torch.int64)
    seeded = q0 < P
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    cov, mm, n_nodes = zeros, zeros, zeros
    buf = torch.full((B, M, 2), -1, dtype=torch.int32, device=dev)

    # ---- left extension (src/pseudoaligner.rs:124-205) ----
    thresh = torch.floor(
        torch.tensor(meta.left_extend_fraction, dtype=torch.float32)
        * lens.to(torch.float32)).to(torch.int64)
    active = seeded & (q0 >= thresh)
    node = node0
    pko = torch.where(off0 > 0, off0 - 1, 0)
    last_pos = q0 - 1
    it = 0
    lcap = meta.max_left_iters
    while bool(active.any()) and (lcap == 0 or it < lcap):
        act = active
        nrow = node_row[node.clamp(min=0)]
        maxm = torch.minimum(last_pos + 1, pko + 1)
        mis = (ctx.pool_window(nrow[:, 0] + pko, -1)
               != ctx.read_window(last_pos, -1))
        matched, mm_add, prem = ctx.segment(mis, maxm)
        cov = torch.where(act, cov + matched, cov)
        mm = torch.where(act, mm + mm_add, mm)
        stop = (last_pos + 1 - matched == 0) | prem
        lp2 = last_pos - matched
        nb = ctx.reads[ctx.rows, lp2.clamp(0, meta.read_len - 1)]
        has = ((nrow[:, 2] >> (4 + nb)) & 1) == 1
        follow = act & ~stop & has
        new_node = nrow[ctx.rows, 8 + nb]
        new_row = node_row[new_node.clamp(min=0)]
        n_nodes = _push(buf, n_nodes, new_node, new_row[:, 3], follow)
        active = follow
        node = torch.where(follow, new_node, node)
        pko = torch.where(follow, new_row[:, 1] - k, pko)
        last_pos = torch.where(act, lp2, last_pos)
        it += 1
    capped = active if lcap > 0 else torch.zeros_like(active)

    # ---- forward walk (src/pseudoaligner.rs:208-302) ----
    active = seeded
    seeking = torch.zeros_like(seeded)
    node, koff, kpos = node0, off0, q0
    it = 0
    wcap = meta.max_walk_iters
    while bool(active.any()) and (wcap == 0 or it < wcap):
        act = active & ~seeking
        fnode = node.clamp(min=0)
        kp = kpos + k
        cov = torch.where(act, cov + k, cov)
        ref_off = koff + k
        nrow = node_row[fnode]
        n_nodes = _push(buf, n_nodes, fnode, nrow[:, 3], act)
        maxm = torch.clamp(
            torch.minimum(lens64 - kp, nrow[:, 1] - ref_off), min=0)
        mis = (ctx.pool_window(nrow[:, 0] + ref_off, 1)
               != ctx.read_window(kp, 1))
        matched, mm_add, prem = ctx.segment(mis, maxm)
        kp = kp + matched
        cov = torch.where(act, cov + matched, cov)
        mm = torch.where(act, mm + mm_add, mm)
        at_end = kp >= lens64
        nb = ctx.reads[ctx.rows, kp.clamp(0, meta.read_len - 1)]
        hasr = ~prem & (((nrow[:, 2] >> nb) & 1) == 1)
        follow = act & ~at_end & hasr
        nxt = nrow[ctx.rows, 4 + nb]
        # re-seed (src/pseudoaligner.rs:285-299): on-grid positions read
        # the next-hit table; lazy off-grid positions enter seek mode
        can_seek = act & ~at_end & ~hasr & (kp <= lens64 - k)
        if meta.lazy_seeds:
            on_grid = kp % 3 == 0
            tbl = can_seek & on_grid
            enter_seek = can_seek & ~on_grid
        else:
            tbl = can_seek
            enter_seek = torch.zeros_like(can_seek)
        trip = nh3[ctx.rows, kp.clamp(0, P - 1)].to(torch.int64)
        found = tbl & (trip[:, 0] < P)
        node2 = torch.where(follow, nxt, torch.where(found, trip[:, 1], node))
        koff2 = torch.where(follow, 0, torch.where(found, trip[:, 2], koff))
        kpos2 = torch.where(follow, kp - (k - 1),
                            torch.where(found, trip[:, 0], kp))
        cov = torch.where(follow, cov - (k - 1), cov)
        active2 = follow | found | enter_seek
        seeking2 = enter_seek
        if meta.lazy_seeds and bool(seeking.any()):
            # seek lanes spend this iteration on one exact probe at kpos;
            # a miss steps by 3 while a k-mer still fits
            s = seeking.nonzero(as_tuple=True)[0]
            skp = kpos[s]
            pn, po = cuckoo_lookup(meta, idx, ctx.kmer_at(ctx.reads[s], skp))
            hit = pn >= 0
            keep = ~hit & (skp + 3 <= lens64[s] - k)
            node2[s] = torch.where(hit, pn.to(torch.int64), node2[s])
            koff2[s] = torch.where(hit, po.to(torch.int64), koff2[s])
            kpos2[s] = torch.where(hit, skp, skp + 3)
            active2[s] = hit | keep
            seeking2[s] = keep
        active, seeking = active2, seeking2
        node, koff, kpos = node2, koff2, kpos2
        it += 1
    if wcap > 0:
        capped = capped | active
    # lanes that pushed past the node buffer lost visits: exact re-map
    capped = capped | (n_nodes > M)
    return _result(meta, buf, cov, mm, n_nodes, capped)


def _result(meta: MapMeta, buf, cov, mm, n_nodes, capped) -> MapResult:
    B = buf.shape[0]
    dev = buf.device
    mapped = n_nodes > 0
    empty = torch.zeros((B, 0), dtype=torch.int32, device=dev)
    ec_bits = torch.zeros((B, 0), dtype=torch.uint32, device=dev)
    if meta.distinct_cap == 0:
        return MapResult(
            mapped=mapped, coverage=cov.to(torch.int32),
            mismatches=mm.to(torch.int32), nodes=buf[:, :, 0].contiguous(),
            n_nodes=n_nodes.to(torch.int32), ec_bits=ec_bits,
            ec_distinct=empty)
    DC = meta.distinct_cap
    v = buf[:, :, 1].to(torch.int64)
    prev = torch.cat(
        [torch.full((B, 1), -1, dtype=torch.int64, device=dev), v[:, :-1]],
        dim=1)
    newrun = (v >= 0) & (v != prev)
    pos = torch.cumsum(newrun.to(torch.int64), dim=1) - 1
    slot = torch.where(newrun, pos.clamp(max=DC), DC)
    out = torch.full((B, DC + 1), -1, dtype=torch.int64, device=dev)
    out.scatter_(1, slot, torch.where(newrun, v, -1))
    dist = out[:, :DC].clone()
    extra = (newrun & (pos >= DC)).any(dim=1)
    dist[:, DC - 1] = torch.where(extra, -2, dist[:, DC - 1])
    dist[:, DC - 1] = torch.where(capped, -3, dist[:, DC - 1])
    return MapResult(
        mapped=mapped,
        coverage=cov.to(torch.uint8 if meta.cov_out_8 else torch.int32),
        mismatches=mm.to(torch.int32), nodes=empty,
        n_nodes=n_nodes.to(torch.int32), ec_bits=ec_bits,
        ec_distinct=dist.to(torch.int16 if meta.ec_out_16 else torch.int32))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def map_batch_packed(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
                     lens: torch.Tensor) -> MapResult:
    """Map a batch: packed [B, ceil(L/16)] int32 reads, lens [B] int32.

    CUDA tensors go through the seed kernel (K1) and the walk kernel (K2);
    a kernel that cannot build or launch raises.  CPU tensors go through
    the plain PyTorch passes."""
    if packed.is_cuda:
        from .kernels import seed_tables_cuda, walk_cuda

        nh3 = seed_tables_cuda(meta, idx, packed, lens)
        return walk_cuda(meta, idx, packed, lens, nh3)
    return walk(meta, idx, packed, lens, seed_tables(meta, idx, packed, lens))
