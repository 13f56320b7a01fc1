"""The batched read-mapping step: device index, seed pass and graph walk.

Port of `pseudoaligner_tpu/ops/map_kernel.py`.  One batch of 2-bit packed
reads goes through two passes:

- the seed pass (`seed_tables`): every probed read position's k-mer is
  looked up in the seed index, and a stride-3 next-hit table
  `nh3 [B, meta.nh3_rows, 3]` gives, for each probed position p, the
  nearest hit q >= p on p's residue grid with its (node, offset): a row
  per position, or under lazy seeds a row per residue-0 position (row j
  for position 3j), the only ones probed;
- the walk (`walk`): per read, left extension under the per-segment SNP
  budget, then the forward unitig walk with re-seeds from `nh3` (or lazy
  seek probes off the residue-0 grid), iteration caps, and the compact
  run-length EC-id output (or the full node list when distinct_cap = 0),
- and, in the full-output shape of a transcriptome of at most
  `bitset_tx_threshold` transcripts (meta.tx_words > 0), the bitset EC
  intersection (`ec_bitset_intersect`): per read, the AND of its classes'
  transcript bitsets.

The seed index (`MapMeta.seed_index`, `seed_probe`) is one of:

- "cuckoo": two candidate 4-slot buckets of keys, values apart;
- "bucket1": one 16-slot bucket of (key, node, offset) slots
  (index/cuckoo.py build_bucket1);
- "mphf": the BBHash MPHF with a stored-key verify (ops/mphf_lookup.py).
  It has no lazy seeds: every position of every residue is probed up front.

`map_batch_packed` runs the CUDA kernels (ops/kernels.py, csrc/seed.cu,
csrc/walk.cu and csrc/ecbits.cu) for CUDA tensors and the plain PyTorch
passes below for CPU tensors.  On the card the seed kernel builds the
table in its step form: a read whose position 0 hits is probed no
further and keeps row 0 alone, and the walk kernel resolves that read's
re-seeds in place; the outputs are those of the whole table.
`map_batch` and `map_batch_with_seeds`
take unpacked base codes and pack them on the device first
(`pack_reads_device`, csrc/pack.cu on a GPU); the second walks from a given
next-hit table, as the k-mer-partitioned step (parallel/sharded_index.py)
builds it from routed seed tables.  The plain passes are batched, masked
tensor code written from the reference's semantics, independent of the
CUDA sources; tests hold them equal to the JAX reference and
chip_smoke.py holds the kernels equal to them on the card.

The reference's left-loop lane compaction flags reads beyond its buffer
-3; the port has no such buffer and maps those reads exactly, and the
records agree because the reference re-maps its -3 reads on the host.

`upload` may ship a large cuckoo table bit-packed (`pack_serving_args`)
and unpack it on the device (`unpack_index`, or csrc/unpack.cu on a GPU)
into exactly the plain upload's arrays.
"""

from __future__ import annotations

import subprocess
import warnings
from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch

from .. import dna, spans
from ..config import AlignerConfig
from ..index.cuckoo import (
    B1_SLOTS,
    EMPTY as CK_EMPTY,
    H1_SEED,
    H2_SEED,
    SLOTS as CK_SLOTS,
    build_bucket1,
    build_cuckoo_fast,
)
from .hashing import MASK32, hash_kmer
from .kmers import all_kmers
from .mphf_lookup import MphfMeta, verified_lookup

# what loading one of the native host helpers raises when its toolchain or
# library is unavailable (they compile on first use)
NATIVE_ERRORS = (ImportError, OSError, subprocess.CalledProcessError)

SEED_INDEXES = ("cuckoo", "bucket1", "mphf")
# the arrays only the MPHF probe (and batch_stats) reads
MPHF_ARRAYS = ("mphf_bits", "mphf_ranks", "kmer_keys", "kmer_node",
               "kmer_offset")
# the slot-ordered arrays an upload keeps as one record per MPHF slot
RECORD_ARRAYS = ("kmer_keys", "kmer_node", "kmer_offset")
# the default gate of the packed upload: cuckoo keys plus values of at
# least this many bytes travel bit-packed (the reference's
# PA_PACK_UPLOAD_MIN default)
PACK_MIN_BYTES = 128 << 20


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
    cuckoo: object  # cuckoo: [NB, SLOTS*W] keys-only bucket rows, empty
    #                 slots hold all-ones keys (a real all-ones k-mer lives
    #                 in meta); bucket1: [NB, B1_SLOTS*(W+2)] rows of
    #                 (key, node, offset) slots, empty ones with node EMPTY;
    #                 mphf: a [1, SLOTS*W] dummy
    cuckoo_vals: object  # cuckoo: [NB*SLOTS*2] flat (node, offset) slot
    #                      values; else a [2] dummy
    mphf_bits: object  # [bw] MPHF level bit words
    mphf_ranks: object  # [bw] set bits of the level before each word;
    #                     uploaded, both are columns of one [bw, 2] tensor
    #                     (mphf_pairs)
    kmer_keys: object  # [nk, W] slot-ordered k-mer words
    kmer_node: object  # [nk] slot -> node
    kmer_offset: object  # [nk] slot -> offset in the node; uploaded with
    #                      the MPHF, the three are column ranges of one
    #                      [nk, record_words(W)] tensor (kmer_records)
    ec_bits: object  # [n_ecs, TW] per-class transcript bitsets (bit t of
    #                  word w = transcript 32w + t), or [1, 0] when
    #                  meta.tx_words == 0

    @property
    def mphf_pairs(self) -> torch.Tensor:
        """[bw, 2] (bit word, rank word) of each MPHF level word: the
        tensor an upload's mphf_bits and mphf_ranks are the columns of."""
        return paired(self.mphf_bits, self.mphf_ranks)

    @property
    def kmer_records(self) -> torch.Tensor:
        """[nk, record_words(W)] (key words, node, offset, zero padding) of
        each MPHF slot: the tensor an upload's kmer_keys, kmer_node and
        kmer_offset are the column ranges of."""
        return records(self.kmer_keys, self.kmer_node, self.kmer_offset)

    def nbytes(self) -> int:
        """Bytes of an uploaded index (tensors), each storage once."""
        return storage_nbytes(getattr(self, f.name) for f in fields(self))


@dataclass(frozen=True)
class MapMeta:
    """Static mapping parameters (the reference MapMeta's fields that the
    port reads)."""

    k: int
    read_len: int  # L, the padded batch width
    allowed_mismatches: int
    left_extend_fraction: float
    max_nodes: int
    cuckoo_mask: int  # bucket count - 1 (cuckoo and bucket1)
    tx_words: int = 0  # ceil(n_tx/32) when the bitset EC path is on, else 0
    seed_index: str = "cuckoo"  # "cuckoo" | "bucket1" | "mphf"
    bucket_seed: int = 0  # bucket1: the (possibly re-salted) hash seed
    mphf: MphfMeta = MphfMeta((), (), (), ())
    # the all-ones k-mer's payload when it is a real key (2k == 32W only):
    # empty cuckoo slots hold the all-ones key pattern
    ones_node: int = -1
    ones_off: int = -1
    pool_pad: int = 256
    distinct_cap: int = 0  # compact EC-id output slots; 0 = full output
    # probe only residue-0 positions up front (cuckoo and bucket1 only:
    # _make_meta turns it off for the MPHF, as the reference does)
    lazy_seeds: bool = False
    max_walk_iters: int = 0  # 0 = unbounded
    max_left_iters: int = 0  # 0 = unbounded
    ec_out_16: bool = False  # compact EC ids as int16
    cov_out_8: bool = False  # compact coverage as uint8

    @property
    def n_positions(self) -> int:
        return self.read_len - self.k + 1

    @property
    def nh3_rows(self) -> int:
        """Rows of the next-hit table a step builds: the grid the seed pass
        probes, every third position (residue 0) under lazy seeds, else
        every position (common.cuh nh3_rows)."""
        P = self.n_positions
        return (P + 2) // 3 if self.lazy_seeds else P

    @property
    def kmer_words(self) -> int:
        return dna.kmer_words(self.k)


class MapResult(NamedTuple):
    """Per-read outputs of one mapping step (the reference's fields).

    Compact mode (distinct_cap > 0): `ec_distinct [B, DC]` holds each
    read's run-compacted EC ids, -1 padded; the last slot is -2 when more
    than DC runs were visited and -3 when a cap cut the walk (both mean:
    re-map this read exactly).  Full mode: `nodes [B, max_nodes]`, and
    `ec_bits [B, TW]` when meta.tx_words > 0."""

    mapped: torch.Tensor  # [B] bool
    coverage: torch.Tensor  # [B] int32 (uint8 when meta.cov_out_8)
    mismatches: torch.Tensor  # [B] int32
    nodes: torch.Tensor  # [B, max_nodes] int32, or [B, 0] in compact mode
    n_nodes: torch.Tensor  # [B] int32, all pushes (may exceed max_nodes)
    ec_bits: torch.Tensor  # [B, TW] uint32 intersected transcript bitsets
    #                        (zeros for unmapped reads); [B, 0] in compact
    #                        mode or when meta.tx_words == 0
    ec_distinct: torch.Tensor  # [B, DC] int32/int16, or [B, 0]


# ---------------------------------------------------------------------------
# image -> device index
# ---------------------------------------------------------------------------


def pack_reads_host(codes: np.ndarray) -> np.ndarray:
    """[B, L] uint8 codes -> [B, ceil(L/16)] uint32, 16 bases per word,
    base i at bits 2*(i % 16) (C++ packer, NumPy fallback)."""
    with spans.span("pa.host_pack"):
        try:
            from ..io.native import pack_reads

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


def lens_link_dtype(read_len: int):
    """Narrowest numpy dtype that holds read lengths up to `read_len`: the
    lens vector's type on the host-to-device link (the step casts it to
    int32 on the device)."""
    return (np.uint8 if read_len <= 255 else
            np.uint16 if read_len <= 65535 else np.int32)


def _pack_pool_rows(seq_pool: np.ndarray, pad_front: int,
                    pad_back: int) -> np.ndarray:
    """uint8 base codes -> [R, 8] uint32 rows (128 bases/row), zero padded
    (the reference's layout at pool_stride = 0)."""
    total = pad_front + len(seq_pool) + pad_back
    total = (total + 127) // 128 * 128
    codes = np.zeros(total, dtype=np.uint8)
    codes[pad_front : pad_front + len(seq_pool)] = seq_pool
    return dna.pack_codes_2bit(codes).reshape(-1, 8)


def build_ec_bitsets(ec_offsets: np.ndarray, ec_txs: np.ndarray,
                     n_tx: int) -> np.ndarray:
    """[M, ceil(n_tx/32)] uint32: bit t of word w = transcript 32w+t."""
    M = len(ec_offsets) - 1
    TW = (n_tx + 31) // 32
    bits = np.zeros((M, TW), dtype=np.uint32)
    lens = np.diff(ec_offsets.astype(np.int64))
    ec_of_entry = np.repeat(np.arange(M), lens)
    tx = ec_txs.astype(np.int64)
    np.bitwise_or.at(
        bits, (ec_of_entry, tx >> 5),
        np.uint32(1) << (tx & 31).astype(np.uint32))
    return bits


def _tx_words(image, config: AlignerConfig) -> int:
    """Bitset width of the EC path: ceil(n_tx/32) when the transcriptome
    has at most config.bitset_tx_threshold transcripts, else 0 (the
    reference's `_derived_knobs`)."""
    n_tx = len(image.tx_names)
    return (n_tx + 31) // 32 if n_tx <= config.bitset_tx_threshold else 0


def _pool_pad(max_read_len: int) -> int:
    """Zero bases at each end of the pool: at least one read length, so
    no compare window of a node leaves the pool (the reference's
    `_derived_knobs` pool_pad)."""
    return ((max_read_len + 127) // 128 + 1) * 128


def device_index_from_image(image, config: AlignerConfig):
    """IndexImage -> (DeviceIndex of numpy arrays, MapMeta).

    Builds the same arrays as the reference's `device_index_from_image` at
    pool_overlap=False, for each of its seed indexes; the reference's
    on-disk devcache is neither read nor written."""
    if config.seed_index not in SEED_INDEXES:
        raise ValueError(f"seed_index={config.seed_index!r}, expected one "
                         f"of {SEED_INDEXES}")
    with spans.span("pa.serve_init.arrays"):
        pool_pad = _pool_pad(config.max_read_len)
        tx_words = _tx_words(image, config)
        pool_rows = _pack_pool_rows(image.seq_pool, pool_pad, pool_pad)
        ec_bits = (build_ec_bitsets(image.ec_offsets, image.ec_txs,
                                    len(image.tx_names))
                   if tx_words > 0 else np.zeros((1, 0), np.uint32))

        node_row = np.zeros((image.n_nodes, 12), dtype=np.int32)
        node_row[:, 0] = image.node_start.astype(np.int64) + pool_pad
        node_row[:, 1] = image.node_len
        node_row[:, 2] = image.node_exts
        node_row[:, 3] = image.node_ec
        node_row[:, 4:8] = image.r_edge
        node_row[:, 8:12] = image.l_edge

        cuckoo, cuckoo_vals, mask, bucket_seed, ones_node, ones_off = (
            _seed_table(image, config.seed_index))
        dev = DeviceIndex(
            pool_rows=pool_rows, node_row=node_row, cuckoo=cuckoo,
            cuckoo_vals=cuckoo_vals,
            mphf_bits=image.mphf.bits, mphf_ranks=image.mphf.ranks,
            kmer_keys=image.kmer_keys,
            kmer_node=image.kmer_node.astype(np.int32),
            kmer_offset=image.kmer_offset.astype(np.int32), ec_bits=ec_bits)
        meta = _make_meta(image, config, tx_words, mask, bucket_seed,
                          ones_node, ones_off, pool_pad)
        return dev, meta


def _seed_table(image, seed_index: str):
    """The seed index's table: (cuckoo, cuckoo_vals, mask, bucket_seed,
    ones_node, ones_off) as DeviceIndex and MapMeta carry them."""
    W = image.kmer_keys.shape[1]
    if seed_index == "mphf":
        return (np.zeros((1, CK_SLOTS * W), np.uint32), np.zeros(2, np.uint32),
                0, 0, -1, -1)
    with spans.span("pa.serve_init.table"):
        if seed_index == "bucket1":
            cuckoo, mask, bucket_seed = build_bucket1(
                image.kmer_keys, image.kmer_node, image.kmer_offset)
            return cuckoo, np.zeros(2, np.uint32), mask, bucket_seed, -1, -1
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
            # the all-ones k-mer is real at word-filling k and collides
            # with the empty-slot key pattern: its payload rides in meta
            hit = np.all(image.kmer_keys == np.uint32(0xFFFFFFFF),
                         axis=1).nonzero()[0]
            if len(hit):
                ones_node = int(image.kmer_node[hit[0]])
                ones_off = int(image.kmer_offset[hit[0]])
        return cuckoo, cuckoo_vals, ck.mask, 0, ones_node, ones_off


def _make_meta(image, config: AlignerConfig, tx_words: int,
               cuckoo_mask: int, bucket_seed: int, ones_node: int,
               ones_off: int, pool_pad: int) -> MapMeta:
    compact = config.distinct_cap > 0
    return MapMeta(
        k=image.k,
        read_len=config.max_read_len,
        allowed_mismatches=config.allowed_mismatches,
        left_extend_fraction=config.left_extend_fraction,
        max_nodes=config.max_nodes,
        cuckoo_mask=cuckoo_mask,
        tx_words=tx_words,
        seed_index=config.seed_index,
        bucket_seed=bucket_seed,
        mphf=MphfMeta.of(image.mphf),
        ones_node=ones_node,
        ones_off=ones_off,
        pool_pad=pool_pad,
        distinct_cap=config.distinct_cap,
        lazy_seeds=(config.lazy_seeds
                    and config.seed_index in ("cuckoo", "bucket1")),
        # the caps need the compact -3 marker channel for exact re-maps
        max_walk_iters=config.max_walk_iters if compact else 0,
        max_left_iters=config.max_left_iters if compact else 0,
        ec_out_16=compact and image.n_ecs < 2**15 - 4,
        cov_out_8=compact and config.max_read_len <= 255,
    )


def _as_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32/int32 array -> int32 tensor (uint32 as bit pattern).
    A read-only array (an mmapped index) is shared, not copied, on the
    CPU: the index tensors are only ever read."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable", UserWarning)
        t = torch.from_numpy(a.astype(np.int32, copy=False))
    return t.to(device)


def storage_nbytes(tensors) -> int:
    """Bytes of the storages under `tensors`, each counted once (views of
    one tensor, such as the MPHF's paired words, share a storage)."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def paired_upload(a: np.ndarray, b: np.ndarray, device):
    """Two [n] uint32/int32 arrays -> int32 views of columns 0 and 1 of
    one [n, 2] tensor on `device`: word i of `a` beside word i of `b`, so
    a kernel reads both with one 8-byte load."""
    t = _as_tensor(np.stack([np.asarray(a).view(np.int32),
                             np.asarray(b).view(np.int32)], axis=1), device)
    return t[:, 0], t[:, 1]


def paired(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The [n, 2] int32 tensor whose columns `a` and `b` are (as
    paired_upload made them); raises ValueError on two separate tensors."""
    n = a.shape[0]
    if n == 0 and b.shape == a.shape:
        return a.new_empty((0, 2))
    if (a.dim() != 1 or b.shape != a.shape or a.stride() != (2,)
            or b.stride() != (2,) or b.data_ptr() != a.data_ptr() + 4
            or a.untyped_storage().data_ptr()
            != b.untyped_storage().data_ptr()):
        raise ValueError("the MPHF's bit and rank words must be the columns "
                         "of one [n, 2] tensor (map_kernel.paired_upload)")
    return a.as_strided((n, 2), (2, 1))


def record_words(W: int) -> int:
    """Words of a record of W key words, node and offset: 4 (16 bytes)
    for W <= 2, else 8, so a record never straddles a 32-byte sector."""
    return 4 if W + 2 <= 4 else 8


def record_upload(keys: np.ndarray, values, device) -> torch.Tensor:
    """Key words [n, W] and a sequence of value arrays ([n] or [n, c]),
    uint32 or int32 -> one [n, record_words(W)] int32 tensor on `device`:
    each row the key words, then the values in order, then zero padding,
    so a kernel verifies a key and reads its values with one 16- or
    32-byte load.  Each array is copied as it is and placed on the device:
    the host makes no pass over the records."""
    n, W = keys.shape
    rec = torch.zeros((n, record_words(W)), dtype=torch.int32, device=device)
    rec[:, :W] = _as_tensor(keys, device)
    at = W
    for v in values:
        t = _as_tensor(v, device).reshape(n, -1)
        rec[:, at:at + t.shape[1]] = t
        at += t.shape[1]
    return rec


def records(keys: torch.Tensor, *values: torch.Tensor) -> torch.Tensor:
    """The [n, record_words(W)] int32 tensor whose column ranges `keys`
    [n, W] and `values` ([n] or [n, c], in order after the keys) are, as
    record_upload made them; raises ValueError on separate tensors."""
    n, W = keys.shape
    rw = record_words(W)
    if n == 0 and all(v.shape[0] == 0 for v in values):
        return keys.new_empty((0, rw))
    ok = keys.stride() == (rw, 1)
    at = W
    for v in values:
        c = v.shape[1] if v.dim() == 2 else 1
        ok = (ok and v.shape[0] == n and v.stride()[0] == rw
              and (v.dim() == 1 or v.stride()[1] == 1)
              and v.data_ptr() == keys.data_ptr() + 4 * at
              and v.untyped_storage().data_ptr()
              == keys.untyped_storage().data_ptr())
        at += c
    if not ok or at > rw:
        raise ValueError("keys and values must be column ranges of one "
                         "record tensor (map_kernel.record_upload)")
    return keys.as_strided((n, rw), (rw, 1))


def packed_tensors(args: dict, device) -> dict:
    """`pack_serving_args`' arrays -> tensors on `device`: uint32 and
    uint16 as their int32 and int16 bit patterns, uint8 as is."""
    signed = {np.dtype(np.uint32): np.int32, np.dtype(np.uint16): np.int16}
    out = {}
    for name, a in args.items():
        a = np.ascontiguousarray(a)
        if a.dtype in signed:
            a = a.view(signed[a.dtype])
        out[name] = torch.from_numpy(a).to(device)
    return out


def upload(dev: DeviceIndex, device, serving: MapMeta | None = None,
           pack: bool | None = None) -> DeviceIndex:
    """Move a numpy DeviceIndex to `device` as int32 tensors.

    With `serving` (the meta the index serves with), the arrays its seed
    index never reads travel as empty dummies, as the reference's
    `upload_device_index` does: the MPHF and the slot-ordered keys and
    values in cuckoo and bucket1 mode.  Without it every array is kept,
    as `batch_stats` needs.  The MPHF's bit and rank words travel side by
    side in one [bw, 2] tensor (`mphf_pairs`), mphf_bits and mphf_ranks
    its columns: the same bytes as two arrays, one load per level probe.
    Where the MPHF is kept, each slot's key words, node and offset are one
    record of `kmer_records` (built on the device by record_upload), and
    kmer_keys, kmer_node and kmer_offset its column ranges: the stored-key
    verify and the value fetch are one load.  At W = 2 (k 16-32) a record
    takes the 16 bytes of the separate arrays; at W = 1, 3 and 4 its
    padding adds 4, 12 and 8 bytes per key.  The counter
    `pa.serve_init.mphf_record_bytes` holds the records' bytes, 0 where
    they are not kept.  Of a cuckoo serving upload,
    `pa.serve_init.packed_bytes` counts the bit-packed arrays K5 decodes
    (the values, and the keys at W = 2), and
    `pa.serve_init.plain_key_bytes` the key rows that cross as they are
    (at W != 2 when packed, every row when not); each is 0 where nothing
    of its kind crossed, and both are 0 under another seed index.

    `pack` chooses the bit-packed upload of the cuckoo keys and values
    (`pack_serving_args`, unpacked on the device by `unpack_index` or, on a
    GPU, csrc/unpack.cu): None applies the reference's gate (a cuckoo
    serving index of more than one bucket whose keys and values take at
    least PACK_MIN_BYTES, and values that fit the packed fields); True
    forces it and raises where the index cannot be packed; False never
    packs.  Either way the uploaded arrays are the same."""
    arrays = {f.name: getattr(dev, f.name) for f in fields(DeviceIndex)}
    keep = serving is None or serving.seed_index == "mphf"
    if not keep:
        W = np.asarray(dev.kmer_keys).shape[1]
        for name in MPHF_ARRAYS:
            arrays[name] = np.zeros((0, W) if name == "kmer_keys" else 0,
                                    np.int32)
    packed = None
    cuckoo = serving is not None and serving.seed_index == "cuckoo"
    if pack is None:
        ck, cv = np.asarray(dev.cuckoo), np.asarray(dev.cuckoo_vals)
        if cuckoo and ck.shape[0] > 1 and (ck.nbytes + cv.nbytes
                                            >= PACK_MIN_BYTES):
            with spans.span("pa.serve_init.pack"):
                packed = pack_serving_args(dev, serving)
    elif pack:
        if not cuckoo:
            raise ValueError("the packed upload takes a cuckoo index and its "
                             "serving meta (upload(..., serving=meta))")
        with spans.span("pa.serve_init.pack"):
            packed = pack_serving_args(dev, serving)
        if packed is None:
            raise ValueError("the index's values do not fit the packed "
                             "fields")
    with spans.span("pa.serve_init.h2d"):
        out = {n: _as_tensor(a, device) for n, a in arrays.items()
               if n not in ("mphf_bits", "mphf_ranks")
               and (packed is None or n not in ("cuckoo", "cuckoo_vals"))
               and not (keep and n in RECORD_ARRAYS)}
        out["mphf_bits"], out["mphf_ranks"] = paired_upload(
            arrays["mphf_bits"], arrays["mphf_ranks"], device)
        rec_bytes = 0
        if keep:
            keys = np.asarray(arrays["kmer_keys"])
            rec = record_upload(keys, (arrays["kmer_node"],
                                       arrays["kmer_offset"]), device)
            W = keys.shape[1]
            out["kmer_keys"] = rec[:, :W]
            out["kmer_node"], out["kmer_offset"] = rec[:, W], rec[:, W + 1]
            rec_bytes = rec.nbytes
        t = {} if packed is None else packed_tensors(packed[0], device)
    spans.count("pa.serve_init.h2d_bytes",
                storage_nbytes([*out.values(), *t.values()]))
    spans.count("pa.serve_init.mphf_record_bytes", rec_bytes)
    spans.count("pa.serve_init.packed_bytes",
                sum(a.nbytes for n, a in t.items() if n != "cuckoo"))
    plain = t.get("cuckoo", out.get("cuckoo")) if cuckoo else None
    spans.count("pa.serve_init.plain_key_bytes",
                0 if plain is None else plain.nbytes)
    if packed is not None:
        cfg = packed[1]
        if t["vals_lo"].is_cuda:
            from .kernels import unpack_index_cuda

            out["cuckoo"], out["cuckoo_vals"] = unpack_index_cuda(t, cfg)
        else:
            with spans.span("pa.serve_init.unpack"):
                out["cuckoo"], out["cuckoo_vals"] = unpack_index(t, cfg)
    return DeviceIndex(**out)


# ---------------------------------------------------------------------------
# the bit-packed upload of the cuckoo tables
# ---------------------------------------------------------------------------


class PackCfg(NamedTuple):
    """Layout of a bit-packed cuckoo upload: the reference's
    `_pack_unpack_jit` signature without the pool (the port's pool never
    overlaps) and without the TPU's tile padding of the slots."""

    pack_keys: bool  # keys ride as keys_lo / keys_hi (W == 2), else plain
    node_bits: int  # node field width; all-ones marks an empty slot
    off_bits: int  # offset field width
    W: int  # key words per slot
    PB: int  # packed key bytes, ceil(2k / 8)
    S: int  # slots (buckets * 4)


def pack_serving_args(dev: DeviceIndex, meta: MapMeta):
    """Host bit-pack of a cuckoo index's keys and values -> (arrays,
    PackCfg), or None when the values do not fit the packed fields.

    The reference's `_pack_serving_args` on the real slots only (no
    padding of the slots to a multiple of 512):

    - vals_lo [S] uint32 / vals_hi [S] uint16: the slot's node in the low
      node_bits bits and its offset above them (empty slots: the all-ones
      node field, offset 0);
    - at W == 2, keys_lo [S] uint32 (key word 0) and keys_hi [S, PB-4]
      uint8 (the low bytes of key word 1, whose bits above 2k are zero);
      at other W the keys-only rows ride plain as `cuckoo`."""
    cuckoo = np.asarray(dev.cuckoo).view(np.uint32)
    vals = np.asarray(dev.cuckoo_vals).view(np.uint32)
    nb = cuckoo.shape[0]
    W = cuckoo.shape[1] // CK_SLOTS
    S = nb * CK_SLOTS
    if vals.shape != (2 * S,):
        return None
    PB = (2 * meta.k + 7) // 8
    node_u = vals[0::2]
    is_empty = node_u == np.uint32(CK_EMPTY)
    # field widths from the actual maxima; the all-ones node field exceeds
    # every real node id
    node_bits = max(1, int(np.asarray(dev.node_row).shape[0]).bit_length())
    offs = vals[1::2].astype(np.uint64)
    off_bits = max(1, int(offs[~is_empty].max(initial=0)).bit_length())
    if not (node_bits <= 30 and off_bits <= 32
            and node_bits + off_bits <= 46):
        return None
    pack_keys = W == 2 and PB < 4 * W
    fmax = np.uint64((1 << node_bits) - 1)
    v = np.where(is_empty, fmax, node_u.astype(np.uint64)) | (
        np.where(is_empty, np.uint64(0), offs) << np.uint64(node_bits))
    args = {"vals_lo": (v & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            "vals_hi": (v >> np.uint64(32)).astype(np.uint16)}
    if pack_keys:
        kb = np.ascontiguousarray(cuckoo.reshape(S, W)).view(
            np.uint8).reshape(S, 4 * W)
        args["keys_lo"] = kb[:, :4].copy().view(np.uint32).reshape(S)
        args["keys_hi"] = np.ascontiguousarray(kb[:, 4:PB])
    else:
        args["cuckoo"] = cuckoo
    return args, PackCfg(pack_keys, node_bits, off_bits, W, PB, S)


def unpack_index(packed: dict, cfg: PackCfg):
    """Plain PyTorch unpack of `pack_serving_args`' arrays (as tensors:
    uint32 and uint16 carried as int32 and int16) -> (cuckoo [S/4, 4W],
    cuckoo_vals [2S]) int32, equal to the plain upload's arrays.

    Empty slots (all-ones node field) come back as (EMPTY, 0), and their
    packed keys, whose high bytes read all-ones, as the all-ones key."""
    vlo = packed["vals_lo"].to(torch.int64) & MASK32
    vhi = packed["vals_hi"].to(torch.int64) & 0xFFFF
    nmask = (1 << cfg.node_bits) - 1
    node = vlo & nmask
    empty = node == nmask
    off = ((vlo >> cfg.node_bits) | (vhi << (32 - cfg.node_bits))) & (
        (1 << cfg.off_bits) - 1)
    node = torch.where(empty, int(CK_EMPTY), node)
    off = torch.where(empty, 0, off)
    vals = _as_i32(torch.stack([node, off], dim=1).reshape(-1))
    if not cfg.pack_keys:
        return packed["cuckoo"], vals
    hi = torch.zeros_like(vlo)
    for j in range(cfg.PB - 4):
        hi |= packed["keys_hi"][:, j].to(torch.int64) << (8 * j)
    hi = torch.where(empty, MASK32, hi)
    lo = packed["keys_lo"].to(torch.int64) & MASK32
    keys = _as_i32(torch.stack([lo, hi], dim=1))
    return keys.reshape(cfg.S // CK_SLOTS, CK_SLOTS * cfg.W), vals


# ---------------------------------------------------------------------------
# the seed pass (plain PyTorch)
# ---------------------------------------------------------------------------


def pack_reads_device(reads: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch pack: [B, L] integer base codes -> [B, ceil(L/16)]
    int32 (uint32 bit patterns), 16 bases per word, base i at bits
    2*(i % 16).  Codes are not masked to two bits, as in the reference."""
    B, L = reads.shape
    nw = (L + 15) // 16
    r = torch.zeros((B, nw * 16), dtype=torch.int64, device=reads.device)
    r[:, :L] = reads.to(torch.int64) & MASK32
    shifts = torch.arange(16, dtype=torch.int64, device=reads.device) * 2
    acc = torch.zeros((B, nw), dtype=torch.int64, device=reads.device)
    for i, part in enumerate((r.reshape(B, nw, 16) << shifts).unbind(2)):
        acc |= part
    return _as_i32(acc & MASK32)


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


def bucket1_lookup(meta: MapMeta, idx: DeviceIndex, words: torch.Tensor):
    """[..., W] int64 k-mer words -> (node, offset) int32, -1 on miss.

    One bucket, hashed with meta.bucket_seed; the first of its B1_SLOTS
    slots whose key matches and whose node is not EMPTY wins.  Empty slots
    hold zero keys, so the node check keeps the all-A k-mer off them."""
    W = words.shape[-1]
    keys = _as_i32(words)
    h = hash_kmer(words, meta.bucket_seed) & meta.cuckoo_mask
    rows = idx.cuckoo[h]  # [..., B1_SLOTS*(W+2)]
    node = torch.full(words.shape[:-1], -1, dtype=torch.int32,
                      device=words.device)
    off = node.clone()
    empty = np.uint32(CK_EMPTY).view(np.int32).item()
    for s in range(B1_SLOTS):
        base = s * (W + 2)
        n = rows[..., base + W]
        hit = ((rows[..., base : base + W] == keys).all(dim=-1)
               & (n != empty) & (node < 0))
        node = torch.where(hit, n, node)
        off = torch.where(hit, rows[..., base + W + 1], off)
    return node, off


def seed_probe(meta: MapMeta, idx: DeviceIndex, words: torch.Tensor):
    """[..., W] int64 k-mer words -> (node, offset) int32 by the seed
    index of meta.seed_index."""
    if meta.seed_index == "bucket1":
        return bucket1_lookup(meta, idx, words)
    if meta.seed_index == "mphf":
        return verified_lookup(words, idx.mphf_bits, idx.mphf_ranks,
                               meta.mphf, idx.kmer_keys, idx.kmer_node,
                               idx.kmer_offset)
    return cuckoo_lookup(meta, idx, words)


def _grid_next_hit(node, off, lens, k: int, P: int, r: int):
    """Seeds node / off [B, n] int32 at the positions r, r + 3, ... of one
    residue grid (-1 where a position has none) -> that grid's next-hit
    rows [B, n, 3] int32: (q, node@q, off@q) for the nearest valid q >= each
    position on the grid (a suffix min, flipped cummin), (P, -1, -1) when
    there is none.  A seed is valid at positions up to len - k."""
    n = node.shape[1]
    pos = r + 3 * torch.arange(n, dtype=torch.int64, device=node.device)
    valid = (node >= 0) & (pos[None, :]
                           <= lens.to(torch.int64)[:, None] - k)
    cand = torch.where(valid, pos[None, :], P)
    q = torch.flip(torch.cummin(torch.flip(cand, [1]), dim=1).values, [1])
    qi = ((q - r) // 3).clamp(max=n - 1)
    hit = q < P
    return torch.stack([q.to(torch.int32),
                        torch.where(hit, node.gather(1, qi), -1),
                        torch.where(hit, off.gather(1, qi), -1)], dim=-1)


def next_hit_table(seed_node, seed_off, lens, k: int, P: int):
    """Seeds at every position, seed_node / seed_off [B, P] int32 -> the
    eager table nh3 [B, P, 3] int32: nh3[b, p] = (q, node@q, off@q) for
    the nearest valid q >= p on p's residue grid, (P, -1, -1) when there
    is none."""
    B = seed_node.shape[0]
    nh3 = torch.empty((B, P, 3), dtype=torch.int32, device=seed_node.device)
    for r in range(min(3, P)):
        nh3[:, r::3] = _grid_next_hit(seed_node[:, r::3], seed_off[:, r::3],
                                      lens, k, P, r)
    return nh3


def seed_tables(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
                lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch seed pass: packed reads -> nh3 [B, meta.nh3_rows, 3]
    int32.

    With meta.lazy_seeds only residue-0 positions are probed, and the
    table holds their grid alone (row j for position 3j): the walk probes
    the other residues lazily and never reads a row for them."""
    P = meta.n_positions
    reads = unpack_reads(packed, meta.read_len)
    kmers = all_kmers(reads, meta.k)
    if meta.lazy_seeds:
        node, off = seed_probe(meta, idx, kmers[:, ::3])
        return _grid_next_hit(node, off, lens, meta.k, P, 0)
    node, off = seed_probe(meta, idx, kmers)
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
        return segment(mismatch, maxm, self.meta.allowed_mismatches)

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


def segment(mismatch: torch.Tensor, maxm: torch.Tensor, allowed: int):
    """Per-segment SNP budget over the first maxm of the [B, n] compared
    bases' mismatch flags -> (matched, mm_add, premature).  The base that
    breaks the budget counts as a mismatch but not as matched."""
    j = torch.arange(mismatch.shape[1], device=mismatch.device)
    in_range = j[None, :] < maxm[:, None]
    c = torch.cumsum((mismatch & in_range).to(torch.int64), dim=1)
    total = c[:, -1]
    prem = total > allowed
    matched = torch.where(prem, ((c <= allowed) & in_range).sum(1), maxm)
    mm_add = torch.where(prem, allowed + 1, total)
    return matched, mm_add, prem


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

    if tuple(nh3.shape) != (B, meta.nh3_rows, 3):
        raise ValueError(f"nh3: shape {tuple(nh3.shape)}, expected "
                         f"{(B, meta.nh3_rows, 3)}")
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
        row = kp // 3 if meta.lazy_seeds else kp
        trip = nh3[ctx.rows, row.clamp(0, meta.nh3_rows - 1)].to(torch.int64)
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
            pn, po = seed_probe(meta, idx, ctx.kmer_at(ctx.reads[s], skp))
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


def ec_bitset_intersect(meta: MapMeta, idx: DeviceIndex,
                        nodes: torch.Tensor, n_nodes: torch.Tensor,
                        mapped: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch bitset EC intersection -> [B, TW] int32 (uint32 bit
    patterns).

    Per read, the AND of idx.ec_bits[node_row[n, 3]] over the classes of
    its first min(n_nodes, max_nodes) nodes (the node buffer holds only
    those), from all-ones; 0 for reads that are not mapped.  AND is
    idempotent, so a class met twice changes nothing."""
    ec = idx.node_row[nodes.clamp(min=0).to(torch.int64), 3]
    return ec_bitset_intersect_classes(
        meta, idx, torch.where(nodes >= 0, ec, -1), n_nodes, mapped)


def ec_bitset_intersect_classes(meta: MapMeta, idx: DeviceIndex,
                                classes: torch.Tensor, n_nodes: torch.Tensor,
                                mapped: torch.Tensor) -> torch.Tensor:
    """ec_bitset_intersect from the class ids the walk pushed, [B, M]
    int32 (-1 in empty slots), in place of node ids: the graph-sharded
    walk's, whose replicated node_row is a placeholder.  Reads no
    node_row."""
    B, M = classes.shape
    dev = classes.device
    n = n_nodes.to(torch.int64).clamp(max=M)
    used = (torch.arange(M, device=dev)[None, :] < n[:, None]) & (classes >= 0)
    ec = classes.clamp(min=0).to(torch.int64)
    bits = torch.full((B, meta.tx_words), -1, dtype=torch.int32, device=dev)
    for j in range(int(n.max()) if B else 0):
        bits &= torch.where(used[:, j, None], idx.ec_bits[ec[:, j]], -1)
    return torch.where(mapped[:, None], bits, 0)


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

    CUDA tensors go through the seed kernel (K1), the walk kernel (K2) and,
    in the full-output shape with meta.tx_words > 0, the bitset EC kernel
    (K4); a kernel that cannot build or launch raises.  CPU tensors go
    through the plain PyTorch passes."""
    with spans.span("pa.step"):
        return _map_packed(meta, idx, packed, lens)


def _map_packed(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
                lens: torch.Tensor) -> MapResult:
    """The step: on a GPU K1 in its step form (first-hit seeding: a read
    whose position 0 hits is probed no further) and K2 on that table."""
    if packed.is_cuda:
        from .kernels import seed_tables_cuda

        nh3 = seed_tables_cuda(meta, idx, packed, lens, first_hit=True)
    else:
        nh3 = seed_tables(meta, idx, packed, lens)
    spans.count("pa.seed.nh3_bytes", nh3.numel() * nh3.element_size())
    spans.count("pa.seed.tables")
    spans.count("pa.seed.reads", packed.shape[0])
    return walk_from_seeds(meta, idx, packed, lens, nh3,
                           first_hit=packed.is_cuda)


def walk_from_seeds(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
                    lens: torch.Tensor, nh3: torch.Tensor,
                    first_hit: bool = False) -> MapResult:
    """The walk and, in the full-output shape with meta.tx_words > 0, the
    bitset EC intersection, from a next-hit table: K2 and K4 for CUDA
    tensors, the plain passes for CPU tensors.  first_hit: nh3 is K1's
    step form (CUDA tensors only)."""
    if packed.is_cuda:
        from .kernels import ec_bits_cuda, walk_cuda

        res = walk_cuda(meta, idx, packed, lens, nh3, first_hit=first_hit)
        intersect = ec_bits_cuda
    else:
        res = walk(meta, idx, packed, lens, nh3)
        intersect = ec_bitset_intersect
    if meta.distinct_cap == 0 and meta.tx_words > 0:
        bits = intersect(meta, idx, res.nodes, res.n_nodes, res.mapped)
        res = res._replace(ec_bits=bits.view(torch.uint32))
    return res


def pack_reads(reads: torch.Tensor) -> torch.Tensor:
    """[B, L] integer base codes -> packed reads: the pack kernel (K6) for a
    CUDA tensor, pack_reads_device for a CPU one.  uint8 and int32 codes go
    to K6's entry of their width as they are; other integer dtypes are
    cast to int32 first."""
    if reads.dtype not in (torch.uint8, torch.int32):
        reads = reads.to(torch.int32)
    reads = reads.contiguous()
    if reads.is_cuda:
        from .kernels import pack_reads_cuda

        return pack_reads_cuda(reads)
    return pack_reads_device(reads)


def map_batch(meta: MapMeta, idx: DeviceIndex, reads: torch.Tensor,
              lens: torch.Tensor) -> MapResult:
    """Map a [B, L] batch of unpacked base codes: packed on the device
    (K6 on a GPU), then map_batch_packed."""
    with spans.span("pa.step"):
        packed = pack_reads(reads)
        return _map_packed(meta, idx, packed, lens.to(torch.int32))


def map_batch_with_seeds(meta: MapMeta, idx: DeviceIndex,
                         reads: torch.Tensor, lens: torch.Tensor,
                         nh3: torch.Tensor) -> MapResult:
    """The walk and EC stages from a given next-hit table (the
    k-mer-partitioned step's; nh3 from next_hit_table) on [B, L] unpacked
    base codes, packed on the device first."""
    packed = pack_reads(reads)
    return walk_from_seeds(meta, idx, packed, lens.to(torch.int32), nh3)
