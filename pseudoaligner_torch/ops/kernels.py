"""Build, bind and launch the CUDA kernels (csrc/seed.cu K1, csrc/walk.cu
K2, csrc/stats.cu K3, csrc/ecbits.cu K4, csrc/unpack.cu K5).

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
INDEX_ARRAYS = ("cuckoo", "cuckoo_vals", "mphf_bits", "mphf_ranks",
                "kmer_keys", "kmer_node", "kmer_offset")
MAX_DISTINCT_CAP = 64  # walk.cu's per-thread slot array

_lock = threading.Lock()
_lib = None
build_log = ""  # ptxas's report of the last build in this process

_P = ctypes.c_void_p
_I = ctypes.c_int


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
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.pa_seed_tables.restype = _I
            lib.pa_seed_tables.argtypes = [_P, _P, _I, _P, _P, _P, _P]
            lib.pa_walk.restype = _I
            lib.pa_walk.argtypes = [_P, _P, ctypes.c_float, _I] + [_P] * 13
            lib.pa_stats.restype = _I
            lib.pa_stats.argtypes = [_P, _P, _I, _P, _P, _P, _P]
            lib.pa_ec_bits.restype = _I
            lib.pa_ec_bits.argtypes = [_I, _I, _I, _I] + [_P] * 7
            lib.pa_unpack_index.restype = _I
            lib.pa_unpack_index.argtypes = ([_I, ctypes.c_longlong, _I, _I,
                                             _I] + [_P] * 7)
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


def _check_batch(meta: MapMeta, packed, lens):
    if not packed.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors")
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
    _check("mphf_bits", idx.mphf_bits, torch.int32, (bw,), dev)
    _check("mphf_ranks", idx.mphf_ranks, torch.int32, (bw,), dev)
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
    if meta.seed_index != "mphf" and nb != meta.cuckoo_mask + 1:
        raise ValueError(f"{nb} bucket rows for cuckoo_mask "
                         f"{meta.cuckoo_mask}")


def _check_inputs(meta: MapMeta, idx: DeviceIndex, packed, lens):
    B, dev = _check_batch(meta, packed, lens)
    _check("node_row", idx.node_row, torch.int32,
           (idx.node_row.shape[0], 12), dev)
    _check("pool_rows", idx.pool_rows, torch.int32,
           (idx.pool_rows.shape[0], 8), dev)
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
    B, dev = _check_inputs(meta, idx, packed, lens)
    _check("nh3", nh3, torch.int32, (B, meta.n_positions, 3), dev)
    lib = _load()
    buf = torch.empty((B, M, 2), dtype=torch.int32, device=dev)
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
        idx.pool_rows.data_ptr(), idx.node_row.data_ptr(), buf.data_ptr(),
        mapped.data_ptr(), coverage.data_ptr(), mismatches.data_ptr(),
        n_nodes.data_ptr(), ec_distinct.data_ptr(), nodes.data_ptr(),
        _stream(dev))
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
    if not nodes.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors")
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
    rc = lib.pa_ec_bits(dev.index, B, M, TW, nodes.data_ptr(),
                        n_nodes.data_ptr(), mapped.data_ptr(),
                        idx.node_row.data_ptr(), idx.ec_bits.data_ptr(),
                        out.data_ptr(), _stream(dev))
    _raise_on(lib, rc, "ec_bits kernel")
    ec_bits_cuda.launches += 1
    return out


ec_bits_cuda.launches = 0


def unpack_index_cuda(packed: dict, cfg: PackCfg):
    """K5: the bit-packed upload's arrays on the card (vals_lo [S] int32,
    vals_hi [S] int16, and keys_lo [S] int32 with keys_hi [S, PB-4] uint8,
    or the plain `cuckoo` rows) -> (cuckoo [S/4, 4W], cuckoo_vals [2S])
    int32, as map_kernel.unpack_index (see csrc/unpack.cu)."""
    vlo = packed["vals_lo"]
    if not vlo.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors")
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
    rc = lib.pa_unpack_index(dev.index, S, cfg.node_bits, cfg.off_bits, hb,
                             vlo.data_ptr(), packed["vals_hi"].data_ptr(),
                             klo, khi, vals.data_ptr(), kout, _stream(dev))
    _raise_on(lib, rc, "unpack kernel")
    unpack_index_cuda.launches += 1
    return cuckoo, vals


unpack_index_cuda.launches = 0


def reset_launch_counts() -> None:
    seed_tables_cuda.launches = 0
    walk_cuda.launches = 0
    stats_cuda.launches = 0
    ec_bits_cuda.launches = 0
    unpack_index_cuda.launches = 0
