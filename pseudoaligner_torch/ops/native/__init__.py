"""ctypes bridge to the native scalar mapper (see mapper.cpp)."""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mapper.cpp")
_lock = threading.Lock()
_lib = None


def _ensure_built() -> str:
    from ..._nativebuild import ensure_built

    return ensure_built(_SRC, "libpamapper.so")


_U32P = ctypes.POINTER(ctypes.c_uint32)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_ensure_built())
            lib.pa_map_reads.restype = None
            lib.pa_map_reads.argtypes = [
                _U8P, _U32P, _U32P, _U8P, _I32P, _I32P,          # graph
                ctypes.c_int32, _U32P, _U32P, _U32P, _U32P,      # mphf meta
                _U32P, _U32P,                                    # bits, ranks
                _U32P, _U32P, _U32P, ctypes.c_int64,             # keys/values
                ctypes.c_int32,                                  # k
                _U8P, _I32P, ctypes.c_int64, ctypes.c_int32,     # reads
                ctypes.c_int32, ctypes.c_double, ctypes.c_int32, # mm, frac, cap
                ctypes.c_int32,                                  # threads
                _I32P, _I32P, _I32P, _I32P,                      # outputs
            ]
            lib.pa_intersect_ecs.restype = None
            lib.pa_intersect_ecs.argtypes = [
                _I64P, ctypes.c_int64, ctypes.c_int32,           # rows
                _I64P, _U32P, ctypes.c_int64,                    # EC CSR, sent
                _U32P, _I64P,                                    # outputs
            ]
            lib.pa_intersect_pairs.restype = None
            lib.pa_intersect_pairs.argtypes = [
                _U32P, _I64P, _U32P, _I64P,                      # A, B CSRs
                ctypes.c_int64, _U32P, _I64P,                    # m, outputs
            ]
            _lib = lib
    return _lib


class HostMapper:
    """Native scalar mapper over an IndexImage — bit-exact with the golden
    oracle (tests/test_host_mapper.py checks every bundled read)."""

    def __init__(self, image, n_threads: int | None = None):
        self._lib = _load()
        self._image = image
        if n_threads is None:
            n_threads = min(16, os.cpu_count() or 2)
        self._n_threads = n_threads
        img = image
        self._arrs = dict(
            seq_pool=np.ascontiguousarray(img.seq_pool, dtype=np.uint8),
            node_start=np.ascontiguousarray(img.node_start, dtype=np.uint32),
            node_len=np.ascontiguousarray(img.node_len, dtype=np.uint32),
            node_exts=np.ascontiguousarray(img.node_exts, dtype=np.uint8),
            l_edge=np.ascontiguousarray(img.l_edge, dtype=np.int32),
            r_edge=np.ascontiguousarray(img.r_edge, dtype=np.int32),
            seeds=np.ascontiguousarray(img.mphf.seeds, dtype=np.uint32),
            masks=np.ascontiguousarray(img.mphf.masks, dtype=np.uint32),
            word_offsets=np.ascontiguousarray(
                img.mphf.word_offsets, dtype=np.uint32),
            key_offsets=np.ascontiguousarray(
                img.mphf.key_offsets, dtype=np.uint32),
            bits=np.ascontiguousarray(img.mphf.bits, dtype=np.uint32),
            ranks=np.ascontiguousarray(img.mphf.ranks, dtype=np.uint32),
            kmer_keys=np.ascontiguousarray(img.kmer_keys, dtype=np.uint32),
            kmer_node=np.ascontiguousarray(img.kmer_node, dtype=np.uint32),
            kmer_offset=np.ascontiguousarray(
                img.kmer_offset, dtype=np.uint32),
        )

    def map_reads(
        self,
        codes: np.ndarray,
        lens: np.ndarray,
        allowed_mismatches: int = 2,
        left_extend_fraction: float = 0.2,
        cap: int | None = None,
    ):
        """codes [n, L] uint8 -> (cov [n], mm [n], nodes [n, cap], n_nodes).

        Unmapped reads: cov=mm=0, n_nodes=0 (golden None semantics)."""
        a = self._arrs
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        n, L = codes.shape
        if cap is None:
            cap = 2 * L + 8
        cov = np.zeros(n, dtype=np.int32)
        mm = np.zeros(n, dtype=np.int32)
        nodes = np.full((n, cap), -1, dtype=np.int32)
        nn = np.zeros(n, dtype=np.int32)
        self._lib.pa_map_reads(
            a["seq_pool"].ctypes.data_as(_U8P),
            a["node_start"].ctypes.data_as(_U32P),
            a["node_len"].ctypes.data_as(_U32P),
            a["node_exts"].ctypes.data_as(_U8P),
            a["l_edge"].ctypes.data_as(_I32P),
            a["r_edge"].ctypes.data_as(_I32P),
            len(a["seeds"]),
            a["seeds"].ctypes.data_as(_U32P),
            a["masks"].ctypes.data_as(_U32P),
            a["word_offsets"].ctypes.data_as(_U32P),
            a["key_offsets"].ctypes.data_as(_U32P),
            a["bits"].ctypes.data_as(_U32P),
            a["ranks"].ctypes.data_as(_U32P),
            a["kmer_keys"].ctypes.data_as(_U32P),
            a["kmer_node"].ctypes.data_as(_U32P),
            a["kmer_offset"].ctypes.data_as(_U32P),
            len(a["kmer_node"]),
            self._image.k,
            codes.ctypes.data_as(_U8P),
            lens.ctypes.data_as(_I32P),
            n,
            L,
            allowed_mismatches,
            float(left_extend_fraction),
            cap,
            self._n_threads,
            cov.ctypes.data_as(_I32P),
            mm.ctypes.data_as(_I32P),
            nodes.ctypes.data_as(_I32P),
            nn.ctypes.data_as(_I32P),
        )
        return cov, mm, nodes, nn


def intersect_ecs(rows: np.ndarray, ec_offsets: np.ndarray,
                  ec_txs: np.ndarray, sent: int):
    """Batch EC-list intersection (C++): rows [m, w] int64 of ascending
    distinct EC ids (>= sent padded) -> (flat uint32, offsets int64[m+1])
    intersected transcript lists per row.  Replaces the per-signature
    python intersect loop on the overflow re-map path (PERF.md)."""
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    m, w = rows.shape
    ec_offsets = np.ascontiguousarray(ec_offsets, dtype=np.int64)
    ec_txs = np.ascontiguousarray(ec_txs, dtype=np.uint32)
    # capacity: each row's result is no longer than its shortest member
    lens_of = np.diff(ec_offsets)
    big = np.int64(1) << 60
    ml = np.where(
        rows < sent, lens_of[np.clip(rows, 0, len(lens_of) - 1)], big
    )
    per = ml.min(axis=1)
    per[per >= big] = 0
    out = np.empty(int(per.sum()), np.uint32)
    offs = np.empty(m + 1, np.int64)
    lib.pa_intersect_ecs(
        rows.ctypes.data_as(_I64P), m, w,
        ec_offsets.ctypes.data_as(_I64P), ec_txs.ctypes.data_as(_U32P),
        sent, out.ctypes.data_as(_U32P), offs.ctypes.data_as(_I64P),
    )
    # `out` is allocated at CAPACITY (shortest-member bound); the C++
    # writes offs with the true lengths — trim the uninitialized tail so
    # len(flat) == offs[-1] holds for every consumer
    return out[: int(offs[-1])], offs


def intersect_pairs(flat_a, offs_a, flat_b, offs_b):
    """Batch intersection of sorted uint32 list pairs (C++): row i ->
    intersect(A[i], B[i]).  Returns (flat uint32, offsets int64[m+1])."""
    lib = _load()
    flat_a = np.ascontiguousarray(flat_a, dtype=np.uint32)
    flat_b = np.ascontiguousarray(flat_b, dtype=np.uint32)
    offs_a = np.ascontiguousarray(offs_a, dtype=np.int64)
    offs_b = np.ascontiguousarray(offs_b, dtype=np.int64)
    m = len(offs_a) - 1
    cap = int(np.minimum(np.diff(offs_a), np.diff(offs_b)).sum())
    out = np.empty(cap, np.uint32)
    oo = np.empty(m + 1, np.int64)
    lib.pa_intersect_pairs(
        flat_a.ctypes.data_as(_U32P), offs_a.ctypes.data_as(_I64P),
        flat_b.ctypes.data_as(_U32P), offs_b.ctypes.data_as(_I64P),
        m, out.ctypes.data_as(_U32P), oo.ctypes.data_as(_I64P),
    )
    return out[: int(oo[-1])], oo  # trim to the used prefix
