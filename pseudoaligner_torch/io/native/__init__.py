"""ctypes bridge to the native FASTQ scanner (see parser.cpp)."""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "parser.cpp")
_lock = threading.Lock()
_lib = None


def _ensure_built() -> str:
    from ..._nativebuild import ensure_built

    return ensure_built(_SRC, "libpaparser.so")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_ensure_built())
            lib.pa_fastq_scan.restype = ctypes.c_int64
            lib.pa_fastq_scan.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int32,
            ]
            _lib = lib
    return _lib


def fastq_scan(buf, start: int, max_reads: int, L: int, end: int | None = None,
               final: bool = True):
    """Scan up to max_reads records from buf[start:end] (bytes, mmap, or
    a uint8 ndarray — the gz streaming buffer hands its backing array in
    directly with `end` at the last complete line, _GzScanBuffer).

    `final=False` (streaming callers mid-stream) disables the
    final-record-without-trailing-newline acceptance, which could
    otherwise consume a zero-length-sequence record split at a chunk
    boundary without its qual line.

    Returns (n, codes [max,L] u8, lens [n], id_spans [n,2], seq_off [n],
    resume_off).  Raises on malformed records."""
    lib = _load()
    arr = (buf if isinstance(buf, np.ndarray)
           else np.frombuffer(buf, dtype=np.uint8))
    stop = len(arr) if end is None else min(int(end), len(arr))
    codes = np.zeros((max_reads, L), dtype=np.uint8)
    lens = np.zeros(max_reads, dtype=np.int32)
    id_off = np.zeros(2 * max_reads, dtype=np.int64)
    seq_off = np.zeros(max_reads, dtype=np.int64)
    resume = ctypes.c_int64(0)
    n = lib.pa_fastq_scan(
        arr.ctypes.data, stop, start, max_reads, L,
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        id_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(resume), 1 if final else 0,
    )
    if n < 0:
        raise ValueError("malformed FASTQ record")
    return (
        int(n), codes, lens[:n], id_off[: 2 * n].reshape(-1, 2),
        seq_off[:n], int(resume.value),
    )


def fastq_scan_prefix(buf, start: int, max_reads: int, P: int,
                      out: np.ndarray | None = None,
                      end: int | None = None, final: bool = True):
    """Scan up to max_reads records from buf[start:end], copying each
    record's first P RAW seq bytes (N/case preserved) into a [max,P]
    uint8 array; too-short rows are 0xFF-filled.  Returns
    (n, out, resume_off)."""
    lib = _load()
    if not hasattr(lib, "_prefix_ready"):
        lib.pa_fastq_scan_prefix.restype = ctypes.c_int64
        lib.pa_fastq_scan_prefix.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
        ]
        lib._prefix_ready = True
    arr = (buf if isinstance(buf, np.ndarray)
           else np.frombuffer(buf, dtype=np.uint8))
    stop = len(arr) if end is None else min(int(end), len(arr))
    if out is None:
        out = np.empty((max_reads, P), dtype=np.uint8)
    resume = ctypes.c_int64(0)
    n = lib.pa_fastq_scan_prefix(
        arr.ctypes.data, stop, start, max_reads, P,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.byref(resume), 1 if final else 0,
    )
    if n < 0:
        raise ValueError("malformed FASTQ record")
    return int(n), out, int(resume.value)


def count_r1keys(arr: np.ndarray, bl: int, wl_sorted: np.ndarray | None):
    """Fused R1 barcode/UMI key derivation for the count path (C++): one
    pass packs both 2-bit keys and binary-searches the whitelist.
    Returns (bckey i64, ukey i64, status u8, pkbc u64, pkumi u64,
    n_short) — see parser.cpp::pa_count_r1keys for the status codes."""
    lib = _load()
    if not hasattr(lib, "_countkeys_ready"):
        lib.pa_count_r1keys.restype = ctypes.c_int64
        lib.pa_count_r1keys.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib._countkeys_ready = True
    n, ml = arr.shape
    arr = np.ascontiguousarray(arr)
    bckey = np.empty(n, np.int64)
    ukey = np.empty(n, np.int64)
    status = np.empty(n, np.uint8)
    pkbc = np.empty(n, np.uint64)
    pkumi = np.empty(n, np.uint64)
    if wl_sorted is not None:
        wlc = np.ascontiguousarray(wl_sorted, dtype=np.uint64)
        wl_ptr = wlc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        m, has_wl = len(wlc), 1
    else:
        wl_ptr, m, has_wl = None, 0, 0
    n_short = lib.pa_count_r1keys(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, ml, bl,
        wl_ptr, m, has_wl,
        bckey.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ukey.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        pkbc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        pkumi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return bckey, ukey, status, pkbc, pkumi, int(n_short)


def _load_emit():
    lib = _load()
    if not hasattr(lib, "_emit_ready"):
        lib.pa_emit_records.restype = ctypes.c_int64
        lib.pa_emit_records.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_char_p),
        ]
        lib.pa_free_buf.restype = None
        lib.pa_free_buf.argtypes = [ctypes.c_char_p]
        lib._emit_ready = True
    return lib


def pack_reads(codes: np.ndarray) -> np.ndarray:
    """[B, L] uint8 base codes -> [B, ceil(L/16)] uint32 packed (C++)."""
    lib = _load()
    if not hasattr(lib, "_pack_ready"):
        lib.pa_pack_reads.restype = None
        lib.pa_pack_reads.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib._pack_ready = True
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    B, L = codes.shape
    out = np.empty((B, (L + 15) // 16), dtype=np.uint32)
    lib.pa_pack_reads(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), B, L,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out


def emit_records_sig(covs, cov_thresh: int, ids_concat: bytes, id_offs,
                     sig_of_read, sig_start, sig_flat,
                     ovr_rows, ovr_start, ovr_ids) -> bytes:
    """Signature-indirect formatting: per-read EC lists come from the
    shared signature tables (rendered once in C++), overflow rows from the
    ovr_* override arrays.  Flags are computed in C++."""
    lib = _load_emit()
    if not hasattr(lib, "_sig_ready"):
        lib.pa_emit_records_sig.restype = ctypes.c_int64
        lib.pa_emit_records_sig.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_char_p),
        ]
        lib._sig_ready = True
    covs = np.ascontiguousarray(covs, dtype=np.int32)
    id_offs = np.ascontiguousarray(id_offs, dtype=np.int64)
    sig_of_read = np.ascontiguousarray(sig_of_read, dtype=np.int64)
    sig_start = np.ascontiguousarray(sig_start, dtype=np.int64)
    sig_flat = np.ascontiguousarray(sig_flat, dtype=np.uint32)
    ovr_rows = np.ascontiguousarray(ovr_rows, dtype=np.int64)
    ovr_start = np.ascontiguousarray(ovr_start, dtype=np.int64)
    ovr_ids = np.ascontiguousarray(ovr_ids, dtype=np.uint32)
    out = ctypes.c_char_p()
    ln = lib.pa_emit_records_sig(
        len(covs),
        covs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cov_thresh,
        ids_concat,
        id_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sig_of_read.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(sig_start) - 1,
        sig_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sig_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ovr_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ovr_rows),
        ovr_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ovr_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(out),
    )
    if ln == -1:
        raise MemoryError("pa_emit_records_sig allocation failed")
    if ln < 0:
        raise ValueError("pa_emit_records_sig: inconsistent overflow rows")
    data = ctypes.string_at(out, ln)
    lib.pa_free_buf(out)
    return data


def emit_records(flags, covs, ids_concat: bytes, id_offs, eq_offsets, eq_ids) -> bytes:
    """Format a batch of records reference-style -> bytes (one line/read)."""
    lib = _load_emit()
    flags = np.ascontiguousarray(flags, dtype=np.uint8)
    covs = np.ascontiguousarray(covs, dtype=np.int32)
    id_offs = np.ascontiguousarray(id_offs, dtype=np.int64)
    eq_offsets = np.ascontiguousarray(eq_offsets, dtype=np.int64)
    eq_ids = np.ascontiguousarray(eq_ids, dtype=np.uint32)
    out = ctypes.c_char_p()
    n = len(flags)
    ln = lib.pa_emit_records(
        n,
        flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        covs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ids_concat,
        id_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        eq_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        eq_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(out),
    )
    if ln < 0:
        raise MemoryError("pa_emit_records allocation failed")
    data = ctypes.string_at(out, ln)
    lib.pa_free_buf(out)
    return data


# --- native streaming gzip source (gzstream.cpp) ---

_gz_lock = threading.Lock()
_gz_lib = None


def _load_gz():
    global _gz_lib
    with _gz_lock:
        if _gz_lib is None:
            from ..._nativebuild import ensure_built

            lib = ctypes.CDLL(ensure_built(
                os.path.join(_DIR, "gzstream.cpp"), "libpagz.so",
                libs=("-lz",)))
            lib.pa_gz_open.restype = ctypes.c_void_p
            lib.pa_gz_open.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
            lib.pa_gz_fill.restype = ctypes.c_int64
            lib.pa_gz_fill.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_char_p, ctypes.c_int64]
            lib.pa_gz_close.restype = None
            lib.pa_gz_close.argtypes = [ctypes.c_void_p]
            _gz_lib = lib
    return _gz_lib


class GzSource:
    """Streaming gzip inflate on a NATIVE producer thread (gzstream.cpp):
    file read + inflate never touch the GIL, and the consumer's fill is
    one ctypes call (GIL released) that memcpy-appends finished chunks
    into the caller's scan buffer.  Multi-member files supported;
    truncated streams raise at fill time."""

    def __init__(self, path: str, chunk: int = 1 << 20,
                 ahead: int = 32 << 20):
        lib = _load_gz()
        self._lib = lib
        self._h = lib.pa_gz_open(path.encode(), chunk, ahead)
        if not self._h:
            raise OSError(f"cannot open {path}")

    def fill_into(self, arr: np.ndarray, cur_len: int, min_len: int):
        """Append into arr[cur_len:]; returns (appended, last_nl, eof)
        where last_nl is one past the last '\\n' across the appended
        region (or -1), eof means stream fully drained."""
        last_nl = ctypes.c_int64(-1)
        eof = ctypes.c_int32(0)
        err = ctypes.create_string_buffer(192)
        n = self._lib.pa_gz_fill(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(arr), cur_len, min_len, ctypes.byref(last_nl),
            ctypes.byref(eof), err, len(err))
        if n < 0:
            raise ValueError(err.value.decode() or "gzip stream error")
        return int(n), int(last_nl.value), bool(eof.value)

    def close(self) -> None:
        h, self._h = self._h, None
        if h:
            self._lib.pa_gz_close(h)

    def __del__(self):  # best-effort: the handle owns a thread + FILE*
        try:
            self.close()
        except Exception:
            pass
