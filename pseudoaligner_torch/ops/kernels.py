"""Build, bind and launch the CUDA kernels: csrc/seed.cu K1 (and its
next_hit entry), csrc/walk.cu K2, csrc/stats.cu K3, csrc/ecbits.cu K4 (and
its entry from class ids), csrc/unpack.cu K5, csrc/pack.cu K6 (uint8 and
int32 entries), csrc/route.cu K7 (route and unscatter), csrc/mphfdyn.cu
K8, csrc/txcounts.cu K9, csrc/gwalk.cu K10 (the graph-sharded walk's
steps) and csrc/gfetch.cu K11 (its owner-side fetch).

The sources compile with nvcc for sm_90a, one nvcc per source, all
started together, and link into one shared library with a plain C
interface, at first use, into pseudoaligner_torch/_build/ under a name
keyed by a hash of the sources; ctypes loads it.  Nothing is built or
loaded at import, so CPU-only hosts import this module freely.

Each wrapper checks its tensors, allocates every output and scratch
buffer with torch.empty, launches on torch.cuda.current_stream() without
synchronising, raises if the launch was refused, and adds one to its
`launches` counter.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .. import spans
from ..index.cuckoo import B1_SLOTS
from ..index.mphf import MAX_LEVELS
from .map_kernel import (
    SEED_INDEXES,
    DeviceIndex,
    MapMeta,
    MapResult,
    PackCfg,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# ptxas -v reports each kernel's registers, shared memory and spills
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
# the int64 launch-parameter vector, in the order of pa::params_from; the
# MPHF's n_levels seeds, masks, word offsets and key offsets follow it
PARAM_NAMES = ("B", "nw", "L", "k", "lazy", "cuckoo_mask", "ones_node",
               "ones_off", "allowed", "max_nodes", "lcap", "wcap", "dc",
               "ec16", "cov8", "mode", "bucket_seed", "n_levels")
# the seed index's arrays, as the host pointer vector of pa::index_from
INDEX_ARRAYS = ("cuckoo", "cuckoo_vals", "mphf_pairs", "kmer_keys",
                "kmer_node", "kmer_offset")
MAX_DISTINCT_CAP = 64  # walk.cu's shared-memory slot columns (32 KB)

_lock = threading.Lock()
_lib = None
build_log = ""  # ptxas's report of the last build in this process

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; their joined output, or raise with the
    output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{out}")
    return "".join(outs)


def build() -> str:
    """Compile the kernels' library if it is not built yet; returns its
    path.  Raises with nvcc's output on failure."""
    global build_log
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    deps = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in srcs + deps:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    tag = h.hexdigest()[:16]
    so = os.path.join(_BUILD, f"libpa_kernels-{tag}.so")
    if os.path.exists(so):
        return so
    nvcc = _nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    pid = os.getpid()
    objs = [os.path.join(_BUILD, f"{os.path.basename(s)}-{tag}.{pid}.o")
            for s in srcs]
    build_log = _run_all([[nvcc, *NVCC_FLAGS, "-c", s, "-o", o]
                          for s, o in zip(srcs, objs)])
    tmp = f"{so}.tmp{pid}"
    _run_all([[nvcc, *ARCH, "-shared", "-o", tmp, *objs]])
    os.replace(tmp, so)
    for o in objs:
        os.remove(o)
    return so


def _load():
    """The kernels' library, built and bound at the first call (the span
    `pa.kernels.load`)."""
    global _lib
    if _lib is not None:
        return _lib
    with spans.span("pa.kernels.load"), _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.pa_seed_tables.restype = _I
            lib.pa_seed_tables.argtypes = [_P, _P, _I, _P, _P, _P, _P]
            lib.pa_walk.restype = _I
            lib.pa_walk.argtypes = [_P, _P, ctypes.c_float, _I] + [_P] * 12
            lib.pa_stats.restype = _I
            lib.pa_stats.argtypes = [_P, _P, _I, _P, _P, _P, _P]
            lib.pa_ec_bits.restype = _I
            lib.pa_ec_bits.argtypes = [_I, _I, _I, _I] + [_P] * 7
            lib.pa_unpack_index.restype = _I
            lib.pa_unpack_index.argtypes = [_I, _L, _I, _I, _I] + [_P] * 7
            lib.pa_next_hit.restype = _I
            lib.pa_next_hit.argtypes = [_I] * 4 + [_P] * 5
            for entry in PACK_ENTRIES.values():
                fn = getattr(lib, entry)
                fn.restype = _I
                fn.argtypes = [_I] * 3 + [_P] * 3
            lib.pa_route.restype = _I
            lib.pa_route.argtypes = [_I] * 7 + [_P] * 9
            lib.pa_unscatter.restype = _I
            lib.pa_unscatter.argtypes = [_I, _L, _L] + [_P] * 5
            lib.pa_mphf_dynamic.restype = _I
            lib.pa_mphf_dynamic.argtypes = [_I, _L, _I, _I] + [_P] * 9
            lib.pa_tx_counts.restype = _I
            lib.pa_tx_counts.argtypes = [_I] * 4 + [_P] * 3
            lib.pa_ec_bits_classes.restype = _I
            lib.pa_ec_bits_classes.argtypes = [_I] * 4 + [_P] * 6
            lib.pa_gwalk_init.restype = _I
            lib.pa_gwalk_init.argtypes = [_P, _P, ctypes.c_float, _I] + [
                _P] * 7
            lib.pa_gwalk_left_a.restype = _I
            lib.pa_gwalk_left_a.argtypes = [_P, _P, _I] + [_P] * 5
            lib.pa_gwalk_left_b.restype = _I
            lib.pa_gwalk_left_b.argtypes = [_P, _P, _I] + [_P] * 5
            lib.pa_gwalk_forward.restype = _I
            lib.pa_gwalk_forward.argtypes = [_P, _P, _I] + [_P] * 8
            lib.pa_gwalk_finish.restype = _I
            lib.pa_gwalk_finish.argtypes = [_P, _I] + [_P] * 9
            lib.pa_gfetch.restype = _I
            lib.pa_gfetch.argtypes = [_I, _L, _I, _I, _I, _L] + [_P] * 5
            lib.pa_error_string.restype = ctypes.c_char_p
            lib.pa_error_string.argtypes = [_I]
            _lib = lib
    return _lib


def _check(name, t: torch.Tensor, dtype, shape, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_aligned(name, t: torch.Tensor, nbytes: int = 16) -> None:
    """The kernels read index rows, K10 and K11 their state, buffers and
    responses, and K4 its output, in 16-byte accesses (requests in 8-byte
    ones)."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: data not {nbytes}-byte aligned")


def _require_cuda(t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors")


def _check_batch(meta: MapMeta, packed, lens):
    _require_cuda(packed)
    dev = packed.device
    if meta.n_positions < 1:
        raise ValueError(f"batch width {meta.read_len} below k={meta.k}")
    B = packed.shape[0]
    _check("packed", packed, torch.int32, (B, (meta.read_len + 15) // 16), dev)
    _check("lens", lens, torch.int32, (B,), dev)
    return B, dev


def _check_mphf(meta: MapMeta, idx: DeviceIndex, dev) -> None:
    """The MPHF and its slot-ordered keys and values, as the MPHF probe
    reads them: every level's bit words inside mphf_bits."""
    m = meta.mphf
    if not 0 < len(m.seeds) <= MAX_LEVELS:
        raise ValueError(f"{len(m.seeds)} MPHF levels, expected 1 to "
                         f"{MAX_LEVELS}")
    bw = idx.mphf_bits.shape[0]
    nk = idx.kmer_keys.shape[0]
    if bw < max(o + (mask + 1) // 32
                for o, mask in zip(m.word_offsets, m.masks)) or nk == 0:
        raise ValueError(f"MPHF arrays of {bw} words and {nk} keys do not "
                         "hold the index's levels (a serving upload of "
                         "another seed index carries them empty)")
    _check("mphf_pairs", idx.mphf_pairs, torch.int32, (bw, 2), dev)
    _check_aligned("mphf_pairs", idx.mphf_pairs)
    _check("kmer_keys", idx.kmer_keys, torch.int32, (nk, meta.kmer_words),
           dev)
    _check("kmer_node", idx.kmer_node, torch.int32, (nk,), dev)
    _check("kmer_offset", idx.kmer_offset, torch.int32, (nk,), dev)


def _check_seed_index(meta: MapMeta, idx: DeviceIndex, dev) -> None:
    """The arrays meta.seed_index's probe reads, at its row widths."""
    W = meta.kmer_words
    nb = idx.cuckoo.shape[0]
    if meta.seed_index == "cuckoo":
        _check("cuckoo", idx.cuckoo, torch.int32, (nb, 4 * W), dev)
        _check("cuckoo_vals", idx.cuckoo_vals, torch.int32, (nb * 8,), dev)
    elif meta.seed_index == "bucket1":
        _check("cuckoo", idx.cuckoo, torch.int32, (nb, B1_SLOTS * (W + 2)),
               dev)
    elif meta.seed_index == "mphf":
        _check_mphf(meta, idx, dev)
    else:
        raise ValueError(f"seed_index={meta.seed_index!r}, expected one of "
                         f"{SEED_INDEXES}")
    for name in ("cuckoo", "cuckoo_vals", "kmer_keys"):
        _check_aligned(name, getattr(idx, name))
    if meta.seed_index != "mphf" and nb != meta.cuckoo_mask + 1:
        raise ValueError(f"{nb} bucket rows for cuckoo_mask "
                         f"{meta.cuckoo_mask}")


def _check_inputs(meta: MapMeta, idx: DeviceIndex, packed, lens,
                  probes: bool = True):
    """The batch, the graph arrays and, when the kernel `probes` the seed
    index, that index's arrays."""
    B, dev = _check_batch(meta, packed, lens)
    _check("node_row", idx.node_row, torch.int32,
           (idx.node_row.shape[0], 12), dev)
    _check("pool_rows", idx.pool_rows, torch.int32,
           (idx.pool_rows.shape[0], 8), dev)
    _check_aligned("node_row", idx.node_row)
    if probes:
        _check_seed_index(meta, idx, dev)
    return B, dev


def _params(meta: MapMeta, B: int) -> torch.Tensor:
    """The launch parameters, then the MPHF's level table."""
    v = dict(B=B, nw=(meta.read_len + 15) // 16, L=meta.read_len, k=meta.k,
             lazy=int(meta.lazy_seeds), cuckoo_mask=meta.cuckoo_mask,
             ones_node=meta.ones_node, ones_off=meta.ones_off,
             allowed=meta.allowed_mismatches, max_nodes=meta.max_nodes,
             lcap=meta.max_left_iters, wcap=meta.max_walk_iters,
             dc=meta.distinct_cap, ec16=int(meta.ec_out_16),
             cov8=int(meta.cov_out_8),
             mode=SEED_INDEXES.index(meta.seed_index),
             bucket_seed=meta.bucket_seed, n_levels=len(meta.mphf.seeds))
    return torch.tensor([v[n] for n in PARAM_NAMES]
                        + [x for col in meta.mphf for x in col],
                        dtype=torch.int64)


def _index_ptrs(idx: DeviceIndex) -> torch.Tensor:
    """Host vector of the seed index's device pointers (pa::index_from)."""
    return torch.tensor([getattr(idx, n).data_ptr() for n in INDEX_ARRAYS],
                        dtype=torch.int64)


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} launch failed: {lib.pa_error_string(rc).decode()} ({rc})")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def seed_tables_cuda(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
                     lens: torch.Tensor) -> torch.Tensor:
    """K1: packed [B, ceil(L/16)] int32 reads, lens [B] int32 ->
    nh3 [B, P, 3] int32 (see csrc/seed.cu)."""
    B, dev = _check_inputs(meta, idx, packed, lens)
    lib = _load()
    nh3 = torch.empty((B, meta.n_positions, 3), dtype=torch.int32,
                      device=dev)
    params, ptrs = _params(meta, B), _index_ptrs(idx)
    rc = lib.pa_seed_tables(
        params.data_ptr(), ptrs.data_ptr(), dev.index, packed.data_ptr(),
        lens.data_ptr(), nh3.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "seed kernel")
    seed_tables_cuda.launches += 1
    return nh3


seed_tables_cuda.launches = 0


def walk_cuda(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
              lens: torch.Tensor, nh3: torch.Tensor) -> MapResult:
    """K2: the walk and output encoding -> MapResult (see csrc/walk.cu)."""
    DC, M = meta.distinct_cap, meta.max_nodes
    if DC > MAX_DISTINCT_CAP or M < 1:
        raise ValueError(f"distinct_cap {DC} > {MAX_DISTINCT_CAP} or "
                         f"max_nodes {M} < 1")
    # the walk probes only in lazy seeks: without them it reads no seed
    # index (the k-mer-partitioned graph carries a placeholder one)
    B, dev = _check_inputs(meta, idx, packed, lens, probes=meta.lazy_seeds)
    _check("nh3", nh3, torch.int32, (B, meta.n_positions, 3), dev)
    lib = _load()
    mapped = torch.empty(B, dtype=torch.bool, device=dev)
    mismatches = torch.empty(B, dtype=torch.int32, device=dev)
    n_nodes = torch.empty(B, dtype=torch.int32, device=dev)
    if DC > 0:
        coverage = torch.empty(
            B, dtype=torch.uint8 if meta.cov_out_8 else torch.int32,
            device=dev)
        ec_distinct = torch.empty(
            (B, DC), dtype=torch.int16 if meta.ec_out_16 else torch.int32,
            device=dev)
        nodes = torch.empty((B, 0), dtype=torch.int32, device=dev)
    else:
        coverage = torch.empty(B, dtype=torch.int32, device=dev)
        ec_distinct = torch.empty((B, 0), dtype=torch.int32, device=dev)
        nodes = torch.empty((B, M), dtype=torch.int32, device=dev)
    params, ptrs = _params(meta, B), _index_ptrs(idx)
    rc = lib.pa_walk(
        params.data_ptr(), ptrs.data_ptr(), meta.left_extend_fraction,
        dev.index, packed.data_ptr(), lens.data_ptr(), nh3.data_ptr(),
        idx.pool_rows.data_ptr(), idx.node_row.data_ptr(), mapped.data_ptr(),
        coverage.data_ptr(), mismatches.data_ptr(), n_nodes.data_ptr(),
        ec_distinct.data_ptr(), nodes.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "walk kernel")
    walk_cuda.launches += 1
    return MapResult(
        mapped=mapped, coverage=coverage, mismatches=mismatches, nodes=nodes,
        n_nodes=n_nodes,
        ec_bits=torch.empty((B, 0), dtype=torch.uint32, device=dev),
        ec_distinct=ec_distinct)


walk_cuda.launches = 0


def stats_cuda(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
               lens: torch.Tensor) -> torch.Tensor:
    """K3: packed [B, ceil(L/16)] int32 reads, lens [B] int32 -> [3] int64
    (valid positions, verified MPHF hits, MPHF false positives); see
    csrc/stats.cu.  Needs the MPHF and key arrays whatever meta.seed_index
    says."""
    B, dev = _check_batch(meta, packed, lens)
    _check_mphf(meta, idx, dev)
    lib = _load()
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    params, ptrs = _params(meta, B), _index_ptrs(idx)
    rc = lib.pa_stats(params.data_ptr(), ptrs.data_ptr(), dev.index,
                      packed.data_ptr(), lens.data_ptr(), counts.data_ptr(),
                      _stream(dev))
    _raise_on(lib, rc, "stats kernel")
    stats_cuda.launches += 1
    return counts


stats_cuda.launches = 0


def ec_bits_cuda(meta: MapMeta, idx: DeviceIndex, nodes: torch.Tensor,
                 n_nodes: torch.Tensor, mapped: torch.Tensor) -> torch.Tensor:
    """K4: a full-output walk's nodes [B, max_nodes] int32, n_nodes [B]
    int32 and mapped [B] bool -> ec_bits [B, TW] int32 (uint32 bit
    patterns; see csrc/ecbits.cu)."""
    _require_cuda(nodes)
    dev, TW = nodes.device, meta.tx_words
    B, M = nodes.shape
    if TW < 1 or M < 1:
        raise ValueError(f"tx_words {TW} and max_nodes {M} must be >= 1")
    _check("nodes", nodes, torch.int32, (B, M), dev)
    _check("n_nodes", n_nodes, torch.int32, (B,), dev)
    _check("mapped", mapped, torch.bool, (B,), dev)
    _check("node_row", idx.node_row, torch.int32,
           (idx.node_row.shape[0], 12), dev)
    _check("ec_bits", idx.ec_bits, torch.int32, (idx.ec_bits.shape[0], TW),
           dev)
    lib = _load()
    out = torch.empty((B, TW), dtype=torch.int32, device=dev)
    _check_aligned("out", out)  # written in 16-byte pieces
    rc = lib.pa_ec_bits(dev.index, B, M, TW, nodes.data_ptr(),
                        n_nodes.data_ptr(), mapped.data_ptr(),
                        idx.node_row.data_ptr(), idx.ec_bits.data_ptr(),
                        out.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "ec_bits kernel")
    ec_bits_cuda.launches += 1
    return out


ec_bits_cuda.launches = 0


def ec_bits_classes_cuda(meta: MapMeta, idx: DeviceIndex,
                         classes: torch.Tensor, n_nodes: torch.Tensor,
                         mapped: torch.Tensor) -> torch.Tensor:
    """K4's entry from class ids: the pushed class ids [B, max_nodes] int32
    (-1 for empty slots) of a graph-sharded walk in place of its node ids,
    n_nodes [B] int32, mapped [B] bool -> ec_bits [B, TW] int32, as
    map_kernel.ec_bitset_intersect_classes.  Reads no node_row."""
    _require_cuda(classes)
    dev, TW = classes.device, meta.tx_words
    B, M = classes.shape
    if TW < 1 or M < 1:
        raise ValueError(f"tx_words {TW} and max_nodes {M} must be >= 1")
    _check("classes", classes, torch.int32, (B, M), dev)
    _check("n_nodes", n_nodes, torch.int32, (B,), dev)
    _check("mapped", mapped, torch.bool, (B,), dev)
    _check("ec_bits", idx.ec_bits, torch.int32, (idx.ec_bits.shape[0], TW),
           dev)
    lib = _load()
    out = torch.empty((B, TW), dtype=torch.int32, device=dev)
    _check_aligned("out", out)
    rc = lib.pa_ec_bits_classes(dev.index, B, M, TW, classes.data_ptr(),
                                n_nodes.data_ptr(), mapped.data_ptr(),
                                idx.ec_bits.data_ptr(), out.data_ptr(),
                                _stream(dev))
    _raise_on(lib, rc, "ec_bits (classes) kernel")
    ec_bits_classes_cuda.launches += 1
    return out


ec_bits_classes_cuda.launches = 0


def unpack_index_cuda(packed: dict, cfg: PackCfg):
    """K5: the bit-packed upload's arrays on the card (vals_lo [S] int32,
    vals_hi [S] int16, and keys_lo [S] int32 with keys_hi [S, PB-4] uint8,
    or the plain `cuckoo` rows) -> (cuckoo [S/4, 4W], cuckoo_vals [2S])
    int32, as map_kernel.unpack_index (see csrc/unpack.cu)."""
    vlo = packed["vals_lo"]
    _require_cuda(vlo)
    dev, S, W = vlo.device, cfg.S, cfg.W
    if not 1 <= cfg.node_bits <= 30 or not 1 <= cfg.off_bits <= 32:
        raise ValueError(f"field widths {cfg.node_bits}, {cfg.off_bits}")
    _check("vals_lo", vlo, torch.int32, (S,), dev)
    _check("vals_hi", packed["vals_hi"], torch.int16, (S,), dev)
    vals = torch.empty(2 * S, dtype=torch.int32, device=dev)
    if cfg.pack_keys:
        if W != 2:
            raise ValueError(f"packed keys need W == 2, got {W}")
        hb = cfg.PB - 4
        _check("keys_lo", packed["keys_lo"], torch.int32, (S,), dev)
        _check("keys_hi", packed["keys_hi"], torch.uint8, (S, hb), dev)
        cuckoo = torch.empty((S // 4, 4 * W), dtype=torch.int32, device=dev)
        klo, khi, kout = (packed["keys_lo"].data_ptr(),
                          packed["keys_hi"].data_ptr(), cuckoo.data_ptr())
    else:
        hb = 0
        cuckoo = packed["cuckoo"]
        _check("cuckoo", cuckoo, torch.int32, (S // 4, 4 * W), dev)
        klo = khi = kout = None
    lib = _load()
    with spans.device_span("pa.serve_init.unpack", dev):
        rc = lib.pa_unpack_index(dev.index, S, cfg.node_bits, cfg.off_bits,
                                 hb, vlo.data_ptr(),
                                 packed["vals_hi"].data_ptr(), klo, khi,
                                 vals.data_ptr(), kout, _stream(dev))
    _raise_on(lib, rc, "unpack kernel")
    unpack_index_cuda.launches += 1
    return cuckoo, vals


unpack_index_cuda.launches = 0


def next_hit_cuda(seed_node: torch.Tensor, seed_off: torch.Tensor,
                  lens: torch.Tensor, k: int) -> torch.Tensor:
    """K1's next_hit entry: seed tables seed_node / seed_off [B, P] int32
    (-1 where a position has no seed), lens [B] int32 -> nh3 [B, P, 3]
    int32, as map_kernel.next_hit_table (see csrc/seed.cu)."""
    _require_cuda(seed_node)
    dev = seed_node.device
    B, P = seed_node.shape
    _check("seed_node", seed_node, torch.int32, (B, P), dev)
    _check("seed_off", seed_off, torch.int32, (B, P), dev)
    _check("lens", lens, torch.int32, (B,), dev)
    lib = _load()
    nh3 = torch.empty((B, P, 3), dtype=torch.int32, device=dev)
    rc = lib.pa_next_hit(dev.index, B, P, k, seed_node.data_ptr(),
                         seed_off.data_ptr(), lens.data_ptr(), nh3.data_ptr(),
                         _stream(dev))
    _raise_on(lib, rc, "next_hit kernel")
    next_hit_cuda.launches += 1
    return nh3


next_hit_cuda.launches = 0


# K6's entries by code dtype: uint8, the width at which the
# k-mer-partitioned path ships codes over the link, and int32
PACK_ENTRIES = {torch.uint8: "pa_pack_reads_u8",
                torch.int32: "pa_pack_reads_i32"}


def _pack(codes: torch.Tensor, dtype) -> torch.Tensor:
    _require_cuda(codes)
    dev = codes.device
    B, L = codes.shape
    # any base address: the kernel takes wide loads only where aligned
    _check("codes", codes, dtype, (B, L), dev)
    lib = _load()
    packed = torch.empty((B, (L + 15) // 16), dtype=torch.int32, device=dev)
    rc = getattr(lib, PACK_ENTRIES[dtype])(dev.index, B, L, codes.data_ptr(),
                                           packed.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "pack kernel")
    return packed


def pack_reads_u8_cuda(codes: torch.Tensor) -> torch.Tensor:
    """K6's uint8 entry: base codes [B, L] uint8 -> packed [B, ceil(L/16)]
    int32 (uint32 bit patterns), as map_kernel.pack_reads_device (see
    csrc/pack.cu).  Codes cross the link at this width on the
    k-mer-partitioned path."""
    packed = _pack(codes, torch.uint8)
    pack_reads_u8_cuda.launches += 1
    return packed


def pack_reads_i32_cuda(codes: torch.Tensor) -> torch.Tensor:
    """K6's int32 entry: base codes [B, L] int32 -> packed, as
    pack_reads_u8_cuda."""
    packed = _pack(codes, torch.int32)
    pack_reads_i32_cuda.launches += 1
    return packed


pack_reads_u8_cuda.launches = 0
pack_reads_i32_cuda.launches = 0


def pack_reads_cuda(codes: torch.Tensor) -> torch.Tensor:
    """K6: base codes [B, L], uint8 or int32, through the entry of their
    dtype (each keeps its own launch counter); any other dtype raises."""
    if codes.dtype == torch.uint8:
        return pack_reads_u8_cuda(codes)
    if codes.dtype == torch.int32:
        return pack_reads_i32_cuda(codes)
    raise TypeError(f"codes: dtype {codes.dtype}, expected torch.uint8 or "
                    "torch.int32")

MAX_SHARDS = 64  # route.cu's per-block owner counters
ROUTE_BLOCK = 256  # route.cu's positions per block


def route_cuda(packed: torch.Tensor, lens: torch.Tensor, k: int,
               read_len: int, n_shards: int, cap: int):
    """K7, route: packed reads [B, ceil(L/16)] int32, lens [B] int32 ->
    (send_q [S, CAP, W] int32, send_src [S, CAP] int32, overflow [] int32,
    dropped [B] bool), as sharded_index.route_queries (see
    csrc/route.cu)."""
    _require_cuda(packed)
    dev = packed.device
    B = packed.shape[0]
    P = read_len - k + 1
    S, W = n_shards, (2 * k + 31) // 32
    if P < 1 or not 1 <= S <= MAX_SHARDS or S & (S - 1) or cap < 1:
        raise ValueError(f"positions {P}, shards {S} (a power of two up to "
                         f"{MAX_SHARDS}), capacity {cap}")
    if B * P >= 2**31:
        raise ValueError(f"{B * P} positions exceed int32 sources")
    _check("packed", packed, torch.int32, (B, (read_len + 15) // 16), dev)
    _check("lens", lens, torch.int32, (B,), dev)
    lib = _load()
    n_blocks = -(-B * P // ROUTE_BLOCK)
    counts = torch.empty(n_blocks * S, dtype=torch.int32, device=dev)
    offsets = torch.empty_like(counts)
    send_q = torch.empty((S, cap, W), dtype=torch.int32, device=dev)
    send_src = torch.empty((S, cap), dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.int32, device=dev)
    dropped = torch.empty(B, dtype=torch.bool, device=dev)
    rc = lib.pa_route(dev.index, B, packed.shape[1], k, P, S, cap,
                      packed.data_ptr(), lens.data_ptr(), counts.data_ptr(),
                      offsets.data_ptr(), send_q.data_ptr(),
                      send_src.data_ptr(), overflow.data_ptr(),
                      dropped.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "route kernels")
    route_cuda.launches += 1
    return send_q, send_src, overflow, dropped


route_cuda.launches = 0


def unscatter_cuda(back: torch.Tensor, src: torch.Tensor, B: int, P: int):
    """K7, unscatter: returned (node, offset) pairs back [N, 2] int32 and
    their flat sources src [N] int32 (-1 for unused slots) -> seed_node,
    seed_off [B, P] int32, -1 where nothing returned, as
    sharded_index.unscatter_seeds (see csrc/route.cu)."""
    _require_cuda(back)
    dev, N = back.device, back.shape[0]
    _check("back", back, torch.int32, (N, 2), dev)
    _check("src", src, torch.int32, (N,), dev)
    lib = _load()
    node = torch.empty((B, P), dtype=torch.int32, device=dev)
    off = torch.empty_like(node)
    rc = lib.pa_unscatter(dev.index, N, B * P, back.data_ptr(),
                          src.data_ptr(), node.data_ptr(), off.data_ptr(),
                          _stream(dev))
    _raise_on(lib, rc, "unscatter kernel")
    unscatter_cuda.launches += 1
    return node, off


unscatter_cuda.launches = 0


def mphf_dynamic_cuda(queries: torch.Tensor, lookup,
                      n_levels: int) -> torch.Tensor:
    """K8: queries [N, W] int32 (uint32 bit patterns) against one shard's
    sub-index `lookup` (a ShardedLookup of that shard's tensors as
    upload_lookup lays them out: the [Wmax, 2] bit and rank pairs, seeds,
    masks, word_offsets, key_offsets [n_levels], the [K, RW] records of
    key words, node and offset, all int32) -> [N, 2] int32 (node, offset),
    -1 on a miss, as mphf_lookup.dynamic_verified_lookup (see
    csrc/mphfdyn.cu)."""
    _require_cuda(queries)
    dev = queries.device
    N, W = queries.shape
    if not 0 < n_levels <= MAX_LEVELS:
        raise ValueError(f"{n_levels} levels, expected 1 to {MAX_LEVELS}")
    _check("queries", queries, torch.int32, (N, W), dev)
    if lookup.keys.shape[1] != W:
        raise ValueError(f"{W}-word queries, {lookup.keys.shape[1]}-word "
                         "keys")
    pairs, records = lookup.pairs, lookup.records
    for name, t, shape in (
            ("pairs", pairs, (lookup.bits.shape[0], 2)),
            ("seeds", lookup.seeds, (n_levels,)),
            ("masks", lookup.masks, (n_levels,)),
            ("word_offsets", lookup.word_offsets, (n_levels,)),
            ("key_offsets", lookup.key_offsets, (n_levels,)),
            ("records", records, records.shape)):
        _check(name, t, torch.int32, shape, dev)
    for name, t in (("queries", queries), ("pairs", pairs),
                    ("records", records)):
        _check_aligned(name, t)
    lib = _load()
    out = torch.empty((N, 2), dtype=torch.int32, device=dev)
    rc = lib.pa_mphf_dynamic(
        dev.index, N, W, n_levels, queries.data_ptr(), pairs.data_ptr(),
        *(getattr(lookup, f).data_ptr() for f in (
            "seeds", "masks", "word_offsets", "key_offsets")),
        records.data_ptr(), out.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "mphf_dynamic kernel")
    mphf_dynamic_cuda.launches += 1
    return out


mphf_dynamic_cuda.launches = 0


def tx_counts_cuda(ec_bits: torch.Tensor, n_tx: int) -> torch.Tensor:
    """K9: EC bitsets [B, TW] int32 (uint32 bit patterns) -> counts [n_tx]
    int32, counts[t] = reads with bit t set, as mesh.tx_compat_counts (see
    csrc/txcounts.cu).  The kernel reads 4-byte words, so any contiguous
    tensor goes, a row slice of a larger one too."""
    _require_cuda(ec_bits)
    dev = ec_bits.device
    B, TW = ec_bits.shape
    if not 0 <= n_tx <= 32 * TW:
        raise ValueError(f"n_tx {n_tx} does not fit {TW} words")
    _check("ec_bits", ec_bits, torch.int32, (B, TW), dev)
    lib = _load()
    counts = torch.empty(n_tx, dtype=torch.int32, device=dev)
    rc = lib.pa_tx_counts(dev.index, B, TW, n_tx, ec_bits.data_ptr(),
                          counts.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "tx_counts kernel")
    tx_counts_cuda.launches += 1
    return counts


tx_counts_cuda.launches = 0

# ---------------------------------------------------------------------------
# K10 and K11: the graph-sharded walk (parallel/graph_walk.py drives them;
# its plain step functions have the same signatures)
# ---------------------------------------------------------------------------


def _gwalk_check(meta: MapMeta, kmeta, st, buf=None, reqs=()):
    """The walk state st [B, NSTATE], the push buffer [B, max_nodes, 2] and
    request buffers [S, B, 2], all int32 on one CUDA device -> (B, dev,
    geo): geo the {S, Nb, WW} launch vector."""
    from ..parallel.graph_walk import NSTATE, window_words

    _require_cuda(st)
    if meta.lazy_seeds or meta.distinct_cap > MAX_DISTINCT_CAP:
        raise ValueError("the graph-sharded walk takes eager seeds and "
                         f"distinct_cap <= {MAX_DISTINCT_CAP}")
    S, Nb = kmeta.n_shards, kmeta.node_block
    if S < 1 or Nb < 1 or meta.max_nodes < 1 or meta.n_positions < 1:
        raise ValueError(f"shards {S}, node block {Nb}, max_nodes "
                         f"{meta.max_nodes}, positions {meta.n_positions}")
    dev, B = st.device, st.shape[0]
    _check("st", st, torch.int32, (B, NSTATE), dev)
    _check_aligned("st", st)
    if buf is not None:
        _check("buf", buf, torch.int32, (B, meta.max_nodes, 2), dev)
        _check_aligned("buf", buf)
    for r in reqs:
        _check("req", r, torch.int32, (S, B, 2), dev)
        _check_aligned("req", r, 8)
    geo = torch.tensor([S, Nb, window_words(meta)], dtype=torch.int64)
    return B, dev, geo


def gwalk_init_cuda(meta: MapMeta, kmeta, nh3, lens, st, buf, req_l,
                    req_f) -> None:
    """K10 init: nh3 [B, P, 3] and lens [B] -> the start state st, the push
    buffer set to -1 and the first left and forward requests (see
    csrc/gwalk.cu)."""
    B, dev, geo = _gwalk_check(meta, kmeta, st, buf, (req_l, req_f))
    _check("nh3", nh3, torch.int32, (B, meta.n_positions, 3), dev)
    _check("lens", lens, torch.int32, (B,), dev)
    lib = _load()
    params = _params(meta, B)
    rc = lib.pa_gwalk_init(params.data_ptr(), geo.data_ptr(),
                           meta.left_extend_fraction, dev.index,
                           nh3.data_ptr(), lens.data_ptr(), st.data_ptr(),
                           buf.data_ptr(), req_l.data_ptr(), req_f.data_ptr(),
                           _stream(dev))
    _raise_on(lib, rc, "gwalk init kernel")
    gwalk_init_cuda.launches += 1


gwalk_init_cuda.launches = 0


def gwalk_left_a_cuda(meta: MapMeta, kmeta, packed, back, st, req) -> None:
    """K10 left_a: the left body up to the successor, from the rows and
    windows back [S, B, 12 + WW]; writes the successor requests."""
    B, dev, geo = _gwalk_check(meta, kmeta, st, None, (req,))
    _check("packed", packed, torch.int32, (B, (meta.read_len + 15) // 16),
           dev)
    _check("back", back, torch.int32, (kmeta.n_shards, B, 12 + int(geo[2])),
           dev)
    _check_aligned("back", back)
    lib = _load()
    params = _params(meta, B)
    rc = lib.pa_gwalk_left_a(params.data_ptr(), geo.data_ptr(), dev.index,
                             packed.data_ptr(), back.data_ptr(),
                             st.data_ptr(), req.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "gwalk left_a kernel")
    gwalk_left_a_cuda.launches += 1


gwalk_left_a_cuda.launches = 0


def gwalk_left_b_cuda(meta: MapMeta, kmeta, back, st, buf, req) -> None:
    """K10 left_b: push the successors from their rows back [S, B, 12];
    writes the next left requests."""
    B, dev, geo = _gwalk_check(meta, kmeta, st, buf, (req,))
    _check("back", back, torch.int32, (kmeta.n_shards, B, 12), dev)
    _check_aligned("back", back)
    lib = _load()
    params = _params(meta, B)
    rc = lib.pa_gwalk_left_b(params.data_ptr(), geo.data_ptr(), dev.index,
                             back.data_ptr(), st.data_ptr(), buf.data_ptr(),
                             req.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "gwalk left_b kernel")
    gwalk_left_b_cuda.launches += 1


gwalk_left_b_cuda.launches = 0


def gwalk_forward_cuda(meta: MapMeta, kmeta, packed, lens, nh3, back, st,
                       buf, req) -> None:
    """K10 forward: one forward body from the rows and windows back
    [S, B, 12 + WW]; writes the next forward requests."""
    B, dev, geo = _gwalk_check(meta, kmeta, st, buf, (req,))
    _check("packed", packed, torch.int32, (B, (meta.read_len + 15) // 16),
           dev)
    _check("lens", lens, torch.int32, (B,), dev)
    _check("nh3", nh3, torch.int32, (B, meta.n_positions, 3), dev)
    _check("back", back, torch.int32, (kmeta.n_shards, B, 12 + int(geo[2])),
           dev)
    _check_aligned("back", back)
    lib = _load()
    params = _params(meta, B)
    rc = lib.pa_gwalk_forward(params.data_ptr(), geo.data_ptr(), dev.index,
                              packed.data_ptr(), lens.data_ptr(),
                              nh3.data_ptr(), back.data_ptr(), st.data_ptr(),
                              buf.data_ptr(), req.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "gwalk forward kernel")
    gwalk_forward_cuda.launches += 1


gwalk_forward_cuda.launches = 0


def gwalk_finish_cuda(meta: MapMeta, kmeta, st, buf) -> MapResult:
    """K10 finish: the walk state and push buffer -> MapResult, encoded as
    K2 encodes it."""
    B, dev, _geo = _gwalk_check(meta, kmeta, st, buf)
    DC, M = meta.distinct_cap, meta.max_nodes
    lib = _load()
    mapped = torch.empty(B, dtype=torch.bool, device=dev)
    mismatches = torch.empty(B, dtype=torch.int32, device=dev)
    n_nodes = torch.empty(B, dtype=torch.int32, device=dev)
    if DC > 0:
        coverage = torch.empty(
            B, dtype=torch.uint8 if meta.cov_out_8 else torch.int32,
            device=dev)
        ec_distinct = torch.empty(
            (B, DC), dtype=torch.int16 if meta.ec_out_16 else torch.int32,
            device=dev)
        nodes = torch.empty((B, 0), dtype=torch.int32, device=dev)
    else:
        coverage = torch.empty(B, dtype=torch.int32, device=dev)
        ec_distinct = torch.empty((B, 0), dtype=torch.int32, device=dev)
        nodes = torch.empty((B, M), dtype=torch.int32, device=dev)
    params = _params(meta, B)
    rc = lib.pa_gwalk_finish(params.data_ptr(), dev.index, st.data_ptr(),
                             buf.data_ptr(), mapped.data_ptr(),
                             coverage.data_ptr(), mismatches.data_ptr(),
                             n_nodes.data_ptr(), ec_distinct.data_ptr(),
                             nodes.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "gwalk finish kernel")
    gwalk_finish_cuda.launches += 1
    return MapResult(
        mapped=mapped, coverage=coverage, mismatches=mismatches, nodes=nodes,
        n_nodes=n_nodes,
        ec_bits=torch.empty((B, 0), dtype=torch.uint32, device=dev),
        ec_distinct=ec_distinct)


gwalk_finish_cuda.launches = 0


def gfetch_cuda(kmeta, me: int, recv, node_rows, pool, ww: int):
    """K11: the requests recv [S, B, 2] int32 that every shard sent shard
    `me`, its block's node_rows [Nb, 12] int32 and flat pool [R] int32
    (uint32 bit patterns) -> responses [S, B, 12 + ww] int32 (see
    csrc/gfetch.cu); ww = 0 fetches rows alone."""
    _require_cuda(recv)
    dev = recv.device
    S, Nb = kmeta.n_shards, kmeta.node_block
    B = recv.shape[1]
    if not 0 <= me < S or Nb < 1 or ww < 0:
        raise ValueError(f"shard {me} of {S}, node block {Nb}, window {ww}")
    _check("recv", recv, torch.int32, (S, B, 2), dev)
    _check("node_rows", node_rows, torch.int32, (Nb, 12), dev)
    _check("pool", pool, torch.int32, (pool.shape[0],), dev)
    _check_aligned("recv", recv, 8)
    _check_aligned("node_rows", node_rows)
    _check_aligned("pool", pool)
    lib = _load()
    out = torch.empty((S, B, 12 + ww), dtype=torch.int32, device=dev)
    rc = lib.pa_gfetch(dev.index, S * B, me, Nb, ww, pool.shape[0],
                       recv.data_ptr(), node_rows.data_ptr(), pool.data_ptr(),
                       out.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "gfetch kernel")
    gfetch_cuda.launches += 1
    return out


gfetch_cuda.launches = 0

GWALK_WRAPPERS = (gwalk_init_cuda, gwalk_left_a_cuda, gwalk_left_b_cuda,
                  gwalk_forward_cuda, gwalk_finish_cuda)
WRAPPERS = (seed_tables_cuda, walk_cuda, stats_cuda, ec_bits_cuda,
            unpack_index_cuda, next_hit_cuda, pack_reads_u8_cuda,
            pack_reads_i32_cuda, route_cuda,
            unscatter_cuda, mphf_dynamic_cuda, tx_counts_cuda,
            ec_bits_classes_cuda, *GWALK_WRAPPERS, gfetch_cuda)


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
