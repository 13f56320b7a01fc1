"""FASTQ streaming input pipeline.

Host input stage feeding fixed-shape read batches to the device mapping
engine.  Replaces the reference's mutexed shared record iterator + worker
threads (reference: src/pseudoaligner.rs:420-474, src/utils.rs:152-157)
with a batch reader: the TPU data-parallel axis replaces the thread pool.
"""

from __future__ import annotations

import gzip
from typing import IO, Iterator

import numpy as np

from ..dna import _ENCODE_LUT


def _open(path: str) -> IO[bytes]:
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def write_bgzf(path: str, data: bytes, member_size: int = 1 << 15,
               level: int = 1) -> None:
    """Write `data` as BGZF-style gzip: independent members whose FEXTRA
    carries the 'BC' subfield with the member's compressed size — the
    common real sequencing-data container (htslib bgzip), and what lets
    the native source inflate members in parallel (gzstream.cpp).  Any
    gzip reader (incl. the Python fallback's multi-member loop)
    decompresses it as plain concatenated gzip."""
    import struct
    import zlib

    with open(path, "wb") as f:
        for i in range(0, max(len(data), 1), member_size):
            chunk = data[i: i + member_size]
            co = zlib.compressobj(level, zlib.DEFLATED, -15)
            comp = co.compress(chunk) + co.flush()
            bsize = 18 + len(comp) + 8 - 1  # total member bytes - 1
            if bsize > 0xFFFF:  # BSIZE is u16 (bgzf spec): incompressible
                raise ValueError(  # input needs a smaller member_size
                    "member compressed size exceeds the BGZF u16 field; "
                    "use member_size <= 32KB")
            f.write(struct.pack("<BBBBIBBH", 0x1F, 0x8B, 8, 4, 0, 0,
                                0xFF, 6)
                    + b"BC" + struct.pack("<HH", 2, bsize) + comp
                    + struct.pack("<II", zlib.crc32(chunk),
                                  len(chunk) & 0xFFFFFFFF))
        # the standard 28-byte BGZF EOF marker (empty member): htslib
        # tools treat its absence as possible truncation (review r5).
        # Our readers see it as a zero-isize member and deliver nothing.
        f.write(bytes.fromhex(
            "1f8b08040000000000ff0600424302001b0003000000000000000000"))


class _GzScanBuffer:
    """Streaming gzip -> native-scanner buffer (VERDICT r3 #4).

    Decompresses chunks into a growable numpy uint8 buffer the C scanner
    (parser.cpp) reads directly — the buffer-fed mode parser.cpp was
    designed for.  Invariants:

    - `arr[:length]` is the decompressed-so-far window; `visible` is the
      end of the last COMPLETE line (scanners must not look past it until
      `eof`, or parser.cpp's final-record-without-newline acceptance
      could mis-fire on a mid-stream chunk boundary).
    - numpy (not bytearray) backing: scan wrappers hand out frombuffer
      views, which would pin a bytearray against resizing.
    - multi-member gzip (bgzf-style concatenation, ubiquitous in
      bioinformatics) is handled by restarting the decompressobj on
      member end.
    """

    def __init__(self, path: str, chunk: int = 1 << 20):
        import os as _os

        self.arr = np.empty(4 << 20, np.uint8)
        self.length = 0
        self.visible = 0
        self.eof = False
        # deliver-then-error contract: a mid-stream inflate error is
        # STASHED here (eof flips true, visible stays at the last
        # complete line) so consumers can emit every record inflated
        # before the corruption point, then raise this at end-of-scan
        self.err: BaseException | None = None
        # adaptive bytes-per-record estimate for right-sizing fills
        self.rec_est = 512
        # zlib inflate is the expensive step (~150-190 MB/s single-stream,
        # i.e. LESS than the device's serving appetite at ~220 MB/s of
        # FASTQ) — run it on a dedicated producer thread so it overlaps
        # the scan + pack + dispatch work instead of serializing with it.
        self._chunk = int(_os.environ.get("PA_GZ_CHUNK", chunk))
        self._f = None
        self._gz = None
        try:
            # native producer (gzstream.cpp): file read + inflate on a
            # GIL-free thread; Python-thread handoff jitter measurably
            # drained the FIFO dispatch pipeline (PERF.md round 4)
            from . import native as _native

            _native._load_gz()  # toolchain errors -> Python fallback
        except Exception:
            _native = None
        if _native is not None:
            # an unopenable file is the caller's error, never a fallback
            self._gz = _native.GzSource(
                path, self._chunk,
                ahead=int(_os.environ.get("PA_GZ_AHEAD", 32 << 20)))
            return
        # no-toolchain fallback: Python inflate thread + bounded queue of
        # decompressed chunks (PA_GZ_DEPTH read-ahead); the consumer
        # memcpy-appends finished chunks (GB/s)
        import queue
        import threading

        self._f = open(path, "rb")
        self._q: queue.Queue = queue.Queue(
            maxsize=int(_os.environ.get("PA_GZ_DEPTH", 8)))
        self._stop = False
        self._th = threading.Thread(target=self._inflate_loop, daemon=True)
        self._th.start()

    def _inflate_loop(self) -> None:
        """Producer: file chunk -> inflate -> bounded queue.  Ends with
        None (clean eof) or an exception object (re-raised in fill)."""
        import zlib

        dec = zlib.decompressobj(wbits=31)
        fed = False  # bytes fed into the CURRENT member
        try:
            while not self._stop:
                data = self._f.read(self._chunk)
                if not data:
                    tail = dec.flush()
                    if tail:
                        self._put(tail)
                    if fed and not dec.eof:
                        raise ValueError("truncated gzip stream")
                    break
                while data and not self._stop:
                    fed = True
                    out = dec.decompress(data)
                    if out:
                        self._put(out)
                    if not dec.eof:
                        break
                    # next gzip member (concatenated/bgzf files)
                    data = dec.unused_data
                    dec = zlib.decompressobj(wbits=31)
                    fed = False
            self._put(None)
        except BaseException as e:  # surfaced at the consumer's fill()
            self._put(e)

    def _put(self, item) -> None:
        """Bounded put; drops (and lets the thread wind down) once the
        consumer has closed — nothing will ever drain the queue then."""
        import queue

        while not self._stop:
            try:
                self._q.put(item, timeout=0.2)
                return
            except queue.Full:
                continue

    def _grow(self, need: int) -> None:
        """Ensure the backing array holds >= need bytes (keeps content)."""
        if need > len(self.arr):
            new = np.empty(max(need, 2 * len(self.arr)), np.uint8)
            new[: self.length] = self.arr[: self.length]
            self.arr = new

    def _append(self, data: bytes) -> None:
        if not data:
            return
        need = self.length + len(data)
        self._grow(need)
        self.arr[self.length: need] = np.frombuffer(data, np.uint8)
        nl = data.rfind(b"\n")
        if nl >= 0:
            self.visible = self.length + nl + 1
        self.length = need

    def compact(self, off: int) -> int:
        """Drop the consumed prefix; returns the new (zero) offset."""
        if off > 0:
            rem = self.length - off
            if rem:
                self.arr[:rem] = self.arr[off: self.length]
            self.length = rem
            self.visible = max(0, self.visible - off)
        return 0

    def fill(self, min_len: int) -> None:
        """Append inflated chunks until length >= min_len or stream end
        (the inflate itself runs ahead on the producer thread)."""
        if self._gz is not None:
            while self.length < min_len and not self.eof:
                if len(self.arr) < min_len or len(self.arr) == self.length:
                    self._grow(max(min_len, len(self.arr) + 1))
                try:
                    app, last_nl, eof = self._gz.fill_into(
                        self.arr, self.length, min_len)
                except Exception as e:
                    self.err = e  # deliver-then-error: see __init__
                    self.eof = True
                    return
                self.length += app
                if last_nl >= 0:
                    self.visible = last_nl
                if eof:
                    self.eof = True
                    self.visible = self.length
            return
        while self.length < min_len and not self.eof:
            item = self._q.get()
            if item is None:
                self.eof = True
                self.visible = self.length
                return
            if isinstance(item, BaseException):
                self.err = item  # deliver-then-error: see __init__
                self.eof = True
                return
            self._append(item)

    def close(self) -> None:
        if self._gz is not None:
            self._gz.close()
            self._gz = None
            return
        f = self._f
        if f is not None:
            self._stop = True  # producer drops instead of blocking
            while True:  # unblock a full queue so the thread can exit
                try:
                    self._q.get_nowait()
                except Exception:
                    break
            self._th.join(timeout=5)
            f.close()
            self._f = None

    def __del__(self):  # best-effort: an abandoned fallback reader must
        try:            # not leave its producer spinning in _put's retry
            self.close()  # loop for the life of the process (native
        except Exception:  # GzSource already has this)
            pass


class ReadBatch:
    """A fixed-shape batch of reads.

    codes: [B, L] uint8 base codes, padded with 0 beyond each read's length
    lens:  [B] int32 read lengths (0 for padding rows)
    ids:   list of read names (len == number of real reads <= B) — LAZY
           when the batch was built from raw id bytes (ids_concat/id_offs):
           the per-read str list only materializes on first access, so the
           emit hot path (which wants concatenated bytes anyway) never pays
           a per-read decode loop
    group: [n_reads] int32 — source-read index; rows sharing a value are
           overlapping windows of one long read (see segment_long)
    offset: [n_reads] int32 — window start within the source read
    ids_concat/id_offs: concatenated raw id bytes + [n+1] int64 offsets
           (the native record emitters' exact input format)
    """

    __slots__ = ("codes", "lens", "_ids", "group", "offset",
                 "ids_concat", "id_offs")

    def __init__(self, codes, lens, ids=None, group=None, offset=None,
                 ids_concat=None, id_offs=None):
        if ids is None and ids_concat is None:
            raise ValueError("ReadBatch needs ids or ids_concat/id_offs")
        self.codes = codes
        self.lens = lens
        self._ids = ids
        self.group = group
        self.offset = offset
        self.ids_concat = ids_concat
        self.id_offs = id_offs

    @property
    def ids(self) -> list[str]:
        if self._ids is None:
            c, o = self.ids_concat, self.id_offs
            self._ids = [
                c[o[i] : o[i + 1]].decode() for i in range(len(o) - 1)
            ]
        return self._ids

    @property
    def n_reads(self) -> int:
        if self._ids is not None:
            return len(self._ids)
        return len(self.id_offs) - 1


def read_fastq_records(path: str) -> Iterator[tuple[str, bytes]]:
    """Yield (read_id, seq_bytes) from a (possibly gzipped) FASTQ file."""
    with _open(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            seq = f.readline().rstrip(b"\r\n")
            plus = f.readline()
            qual = f.readline()
            if not header.startswith(b"@"):
                raise ValueError("malformed FASTQ record")
            if plus == b"":
                # EOF right after the header or seq line: truncation, not
                # malformation (keeps the error class stable for callers)
                raise ValueError("truncated FASTQ record")
            if not plus.startswith(b"+"):
                raise ValueError("malformed FASTQ record")
            if not plus.endswith(b"\n"):
                # '+' line at EOF without its newline: incomplete record
                # (the native scanner requires the separator newline)
                raise ValueError("truncated FASTQ record")
            if (not qual.endswith(b"\n")
                    and len(qual.rstrip(b"\r")) < len(seq)):
                # a final newline-less qual line is complete only if it
                # covers the sequence at TRIMMED length, matching the
                # native scanner's final_chunk acceptance (rust-bio reads
                # qual lines until qual.trim_end().len() >= seq.len(); EOF
                # before that = incomplete, so a zero-length-seq record may
                # end right after its '+' line, and a CRLF file truncated
                # at 'III\r' for a 4-base seq is incomplete).
                raise ValueError("truncated FASTQ record")
            rid = header[1:].split(None, 1)[0].decode()  # first ws-token
            # (matches the native scanner, which stops at space/tab)
            yield rid, seq


def read_fastq_seqs(path: str, chunk_bytes: int = 1 << 26) -> Iterator[bytes]:
    """Yield each record's SEQ line (raw bytes, N preserved) from a
    (possibly gzipped) FASTQ — chunked bulk reads + one split per chunk
    instead of a per-record readline loop (~20x faster; the R1
    barcode/UMI stream of the count pipeline is parse-bound).  Validates
    the 4-line structure ('@' headers, '+' separators, complete final
    record) so a malformed file raises instead of silently desyncing."""
    with _open(path) as f:
        carry = b""
        lineno = 0  # cycles 0 header, 1 seq, 2 plus, 3 qual
        last_seq_len = 0
        pending = [b""]  # seq awaiting its qual line

        def take(ln):
            # the seq is RELEASED only when its qual line arrives: a
            # record cut off after the seq/plus line must raise without
            # delivering it, like read_fastq_records and the native
            # scanner (review r5: the early yield leaked a phantom row)
            nonlocal lineno, last_seq_len
            if lineno == 0 and not ln.startswith(b"@"):
                raise ValueError("malformed FASTQ record")
            if lineno == 2 and not ln.startswith(b"+"):
                raise ValueError("malformed FASTQ record")
            out = None
            if lineno == 1:
                pending[0] = ln.rstrip(b"\r")
                last_seq_len = len(pending[0])
            elif lineno == 3:
                out = pending[0]
            lineno = (lineno + 1) & 3
            return out

        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            lines = (carry + chunk).split(b"\n")
            carry = lines.pop()  # possibly-partial tail line
            for ln in lines:
                seq = take(ln)
                if seq is not None:
                    yield seq
        if carry:
            # a final newline-less qual line is complete only if it
            # covers the sequence at TRIMMED length (native-scanner /
            # rust-bio semantics: a trailing '\r' is not qual coverage)
            if lineno == 3 and len(carry.rstrip(b"\r")) < last_seq_len:
                raise ValueError("truncated FASTQ record")
            if lineno == 2:
                # a '+' line at EOF without its newline: incomplete
                raise ValueError("truncated FASTQ record")
            seq = take(carry)
            if seq is not None:
                yield seq
        elif lineno == 3 and last_seq_len == 0:
            # newline-terminated '+' then EOF: the empty qual of a
            # zero-length-seq record is complete (rust-bio rule) — the
            # held seq releases here since no qual line will arrive
            yield pending[0]
            lineno = 0
        if lineno != 0:
            raise ValueError("truncated FASTQ record")


class R1PrefixReader:
    """Bulk fixed-width R1 prefix stream for the single-cell count path:
    `take(n)` returns an [m, P] uint8 array of each record's first P RAW
    sequence bytes (N and case PRESERVED — barcode/UMI handling needs the
    original bytes; too-short records are 0xFF rows, a byte that never
    occurs in FASTQ text).  Plain files scan via one C++ call per batch
    (no per-record Python objects); gz falls back to the chunked seq
    stream."""

    def __init__(self, path: str, P: int, use_native: bool = True):
        self.P = P
        self._native = None
        self._gzsrc = None
        if use_native:
            try:
                from . import native as _native_mod

                _native_mod._load()  # force the build: toolchain errors
                # must fall back here, not crash the first take()
                if path.endswith(".gz"):
                    self._gzsrc = _GzScanBuffer(path)
                    self._off = 0
                    self._native = _native_mod
                else:
                    import mmap

                    f = open(path, "rb")
                    try:
                        self._buf = mmap.mmap(
                            f.fileno(), 0, access=mmap.ACCESS_READ
                        )
                    except Exception:
                        f.close()
                        raise
                    self._file = f
                    self._off = 0
                    self._native = _native_mod
            except Exception:
                self._native = None
                self._gzsrc = None
        if self._native is None:
            self._seqs = read_fastq_seqs(path)

    def pending_error(self):
        """A stashed mid-stream gz error (deliver-then-error contract):
        callers that would otherwise report a short stream as a
        count-mismatch should raise THIS instead."""
        src = self._gzsrc
        return getattr(src, "err", None) if src is not None else None

    def take(self, n: int) -> np.ndarray:
        """Next n records' prefixes; fewer rows only at end of stream
        (a short return may also mean a stashed error — the NEXT take
        raises it; see pending_error)."""
        P = self.P
        out = np.empty((n, P), dtype=np.uint8)
        if self._gzsrc is not None:
            src = self._gzsrc
            self._off = src.compact(self._off)
            got = 0
            while got < n:
                if self._off >= src.visible:
                    if src.eof:
                        if src.err is not None:
                            if got:  # deliver scanned rows; raise on the
                                break  # next call (got==0 then)
                            raise src.err
                        if self._off < src.length:
                            raise ValueError("truncated FASTQ record")
                        break
                    src.fill(src.length
                             + max((n - got) * src.rec_est, 1 << 20))
                    continue
                m, _, resume = self._native.fastq_scan_prefix(
                    src.arr, self._off, n - got, P, out[got:],
                    end=src.visible, final=src.eof and src.err is None,
                )
                if m == 0:
                    if src.eof:
                        if src.err is not None:
                            if got:
                                break
                            raise src.err
                        if resume < src.visible:
                            raise ValueError("truncated FASTQ record")
                        break
                    src.fill(src.length + (1 << 20))
                    continue
                src.rec_est = max(64, (resume - self._off) // m)
                self._off = resume
                got += m
            return out[:got]
        if self._native is not None:
            got = 0
            while got < n:
                m, _, resume = self._native.fastq_scan_prefix(
                    self._buf, self._off, n - got, P, out[got:]
                )
                if m == 0:
                    if resume < len(self._buf):
                        raise ValueError("truncated FASTQ record")
                    break
                self._off = resume
                got += m
            return out[:got]
        rows = []
        for _ in range(n):
            s = next(self._seqs, None)
            if s is None:
                break
            rows.append(s)
        got = len(rows)
        for i, s in enumerate(rows):
            if len(s) < P:
                out[i] = 0xFF
            else:
                out[i] = np.frombuffer(s[:P], np.uint8)
        return out[:got]

    def close(self) -> None:
        buf = getattr(self, "_buf", None)
        if buf is not None:
            try:
                buf.close()
            except Exception:
                pass
            self._buf = None
        src = getattr(self, "_gzsrc", None)
        if src is not None:
            src.close()
            self._gzsrc = None
        f = getattr(self, "_file", None)
        if f is not None:
            f.close()
            self._file = None


class FastqReader:
    """Batching FASTQ reader producing fixed-shape ReadBatch objects.

    Reads longer than `max_len` are split into overlapping windows
    (overlap `window_overlap`, typically k-1, so every k-mer appears in
    some window) when `segment_long=True` — the long-read segmentation
    path (SURVEY.md section 5.7; the reference handles arbitrary length in
    a scalar loop).  Windows of one read share a `group` value and are
    merged downstream.  With `segment_long=False`, long reads raise.
    """

    def __init__(
        self,
        path: str,
        batch_size: int,
        max_len: int,
        segment_long: bool = False,
        window_overlap: int = 19,
        use_native: bool = True,
        skip_reads: int = 0,
    ):
        self.batch_size = batch_size
        self.max_len = max_len
        self.segment_long = segment_long
        self.window_overlap = window_overlap
        if segment_long and max_len <= window_overlap:
            raise ValueError(
                f"max_read_len={max_len} must exceed the segmentation "
                f"window overlap ({window_overlap}, = k-1): windows "
                "could never advance"
            )
        self._read_index = 0
        self._pending: list[tuple[str, np.ndarray, int, int]] = []
        self._scan_err: Exception | None = None
        self._skip = skip_reads
        self._native = None
        self._gzsrc = None
        if use_native:
            try:
                from . import native as _native_mod

                # force the lazy C++ build NOW: importing the ctypes
                # wrapper always succeeds, so without this probe a
                # toolchain-less host crashes at the first _scan instead
                # of taking the Python fallback below (review r5)
                _native_mod._load()
                if path.endswith(".gz"):
                    # gz fast path: stream-decompress into the scanner's
                    # buffer-fed mode (_GzScanBuffer) — same C scan, same
                    # batch layout as the mmap path
                    self._gzsrc = _GzScanBuffer(path)
                    self._buf = self._gzsrc.arr
                    self._off = 0
                    self._native = _native_mod
                else:
                    import mmap

                    f = open(path, "rb")
                    try:
                        self._buf = mmap.mmap(
                            f.fileno(), 0, access=mmap.ACCESS_READ
                        )
                    except Exception:
                        f.close()
                        raise
                    self._file = f
                    self._off = 0
                    self._native = _native_mod
            except Exception:
                self._native = None
                self._gzsrc = None
        if self._native is None:
            self._records = read_fastq_records(path)
        if self._skip:
            self._do_skip(self._skip)

    def _scan(self, max_n: int, L: int):
        """One logical scan of up to max_n records: a direct C scan on
        the mmap path; on the gz path, compaction + fill/rescan until
        max_n records, end of stream, or a truncation error.  Returns
        the fastq_scan tuple; self._off advances to the resume offset."""
        if self._gzsrc is None:
            return self._native.fastq_scan(self._buf, self._off, max_n, L)
        src = self._gzsrc
        self._off = src.compact(self._off)
        parts = []
        got = 0
        while got < max_n:
            if self._off >= src.visible:
                if src.eof:
                    if src.err is not None:
                        if got:  # deliver scanned records; raise on the
                            break  # next call (got==0 then)
                        raise src.err
                    if self._off < src.length:
                        raise ValueError("truncated FASTQ record")
                    break
                src.fill(src.length
                         + max((max_n - got) * src.rec_est, 1 << 20))
                self._buf = src.arr
                continue
            t = self._native.fastq_scan(
                src.arr, self._off, max_n - got, L, end=src.visible,
                final=src.eof and src.err is None,
            )
            n, resume = t[0], t[5]
            if n == 0:
                if src.eof:
                    if src.err is not None:
                        if got:
                            break
                        raise src.err
                    if resume < src.visible:
                        raise ValueError("truncated FASTQ record")
                    break
                src.fill(src.length + (1 << 20))
                self._buf = src.arr
                continue
            src.rec_est = max(64, (resume - self._off) // n)
            self._off = resume
            got += n
            parts.append(t)
        if len(parts) == 1:
            return parts[0]
        if not parts:
            z = np.zeros
            return (0, z((max_n, L), np.uint8), z(0, np.int32),
                    z((0, 2), np.int64), z(0, np.int64), self._off)
        codes = np.concatenate([t[1][: t[0]] for t in parts], axis=0)
        if len(codes) < max_n:  # callers index codes[:max_n] shapes
            pad = np.zeros((max_n - len(codes), L), np.uint8)
            codes = np.concatenate([codes, pad], axis=0)
        return (
            got,
            codes,
            np.concatenate([t[2] for t in parts]),
            np.concatenate([t[3] for t in parts], axis=0),
            np.concatenate([t[4] for t in parts]),
            self._off,
        )

    def close(self) -> None:
        """Release the mmap/gz/file handles deterministically (also
        called when iteration completes; safe to call twice)."""
        buf = getattr(self, "_buf", None)
        if buf is not None:
            try:
                buf.close()  # mmap; ndarray (gz) has no close
            except Exception:
                pass
            self._buf = None
        src = getattr(self, "_gzsrc", None)
        if src is not None:
            src.close()
            self._gzsrc = None
        f = getattr(self, "_file", None)
        if f is not None:
            f.close()
            self._file = None

    def _do_skip(self, n: int) -> None:
        """Skip the first n reads (restartable streaming / resume)."""
        if self._native is not None:
            left = n
            while left > 0:
                got, _, _, _, _, resume = self._scan(min(left, 65536), 1)
                if got == 0:
                    break
                self._off = resume
                self._read_index += got
                left -= got
        else:
            for _ in range(n):
                if next(self._records, None) is None:
                    break
                self._read_index += 1

    def pending_error(self):
        """A stashed mid-stream gz error (deliver-then-error contract):
        callers that would otherwise report a short stream as a
        count/pairing mismatch should raise THIS instead."""
        src = getattr(self, "_gzsrc", None)
        return getattr(src, "err", None) if src is not None else None

    def __iter__(self) -> Iterator[ReadBatch]:
        while True:
            if self._native is not None and getattr(self, "_buf", None) is None:
                return  # closed
            batch = (
                self._next_batch_native()
                if self._native is not None
                else self._next_batch()
            )
            if batch is None:
                self.close()
                return
            yield batch

    def _next_batch_native(self) -> ReadBatch | None:
        """Bulk batch fill via the C scanner (io/native):
        base codes are written directly in batch layout; long reads fall
        back to the python windowing path."""
        b, L = self.batch_size, self.max_len
        # a stream error stashed while carried rows were delivered
        # surfaces once those rows are out (deliver-then-error)
        if self._scan_err is not None and not self._pending:
            raise self._scan_err
        codes = np.zeros((b, L), dtype=np.uint8)
        lens = np.zeros(b, dtype=np.int32)
        ids: list[str] = []
        group: list[int] = []
        offset: list[int] = []

        # carried long-read windows first (group continuity across batches)
        while len(ids) < b and self._pending:
            rid, enc, g, off = self._pending.pop(0)
            i = len(ids)
            codes[i, : len(enc)] = enc
            lens[i] = len(enc)
            ids.append(rid)
            group.append(g)
            offset.append(off)

        k = len(ids)

        def _partial(err):
            # deliver the k carried (pre-error, complete-record) rows
            # now; re-raise on the next call — the raise used to drop
            # them, violating deliver-then-error (review r5)
            self._scan_err = err
            return ReadBatch(
                codes=codes, lens=lens, ids=ids,
                group=np.asarray(group, dtype=np.int32),
                offset=np.asarray(offset, dtype=np.int32),
            )

        if k < b:
            try:
                n, scodes, slens, id_spans, seq_off, resume = self._scan(
                    b - k, L
                )
            except Exception as e:
                if k == 0:
                    raise
                return _partial(e)
            if (self._gzsrc is None and n == 0
                    and resume < len(self._buf)
                    and self._off < len(self._buf)):
                if k:
                    return _partial(ValueError("truncated FASTQ record"))
                raise ValueError("truncated FASTQ record")
            self._off = resume
            buf = self._buf
            long_mask = slens > L
            if not long_mask.any() and k == 0 and n > 0:
                # fully vectorized path (no carried rows, no long reads):
                # gather the raw id bytes in ONE fancy-index pass and defer
                # per-read str materialization — the emit pipeline consumes
                # exactly this (concat bytes + offsets), so the per-read
                # decode loop vanishes from the serving hot path
                codes[:n] = scodes[:n]
                lens[:n] = slens
                base_g = self._read_index
                self._read_index += n
                starts = id_spans[:n, 0].astype(np.int64)
                blens = id_spans[:n, 1].astype(np.int64)
                offs = np.zeros(n + 1, np.int64)
                np.cumsum(blens, out=offs[1:])
                pos = (np.arange(int(offs[-1]), dtype=np.int64)
                       - np.repeat(offs[:-1], blens)
                       + np.repeat(starts, blens))
                bview = (buf if isinstance(buf, np.ndarray)
                         else np.frombuffer(buf, np.uint8))
                concat = bview[pos].tobytes()
                return ReadBatch(
                    codes=codes, lens=lens,
                    ids_concat=concat, id_offs=offs,
                    group=np.arange(base_g, base_g + n, dtype=np.int32),
                    offset=np.zeros(n, np.int32),
                )
            if not long_mask.any():
                # bulk placement with carried rows ahead: per-row id decode
                codes[k : k + n] = scodes[:n]
                lens[k : k + n] = slens
                base_g = self._read_index
                self._read_index += n
                for j in range(n):
                    ids.append(
                        bytes(
                            buf[id_spans[j, 0] : id_spans[j, 0] + id_spans[j, 1]]
                        ).decode()
                    )
                group.extend(range(base_g, base_g + n))
                offset.extend([0] * n)
            else:
                # slow path: expand long reads into window rows IN ORDER so
                # a read's windows stay adjacent in the stream (the merge
                # stage relies on group contiguity); overflow rows spill to
                # the pending queue for the next batch
                rows: list[tuple[str, np.ndarray, int, int]] = []
                for j in range(n):
                    rid = bytes(
                        buf[id_spans[j, 0] : id_spans[j, 0] + id_spans[j, 1]]
                    ).decode()
                    slen = int(slens[j])
                    if slen <= L:
                        g = self._read_index
                        self._read_index += 1
                        rows.append((rid, scodes[j, :slen], g, 0))
                        continue
                    # long read: shared encode+window logic (_rows_for)
                    raw = bytes(buf[seq_off[j] : seq_off[j] + slen])
                    rows.extend(self._rows_for(rid, raw))
                for row in rows:
                    if len(ids) < b:
                        rid, enc, g, off = row
                        i = len(ids)
                        codes[i, : len(enc)] = enc
                        lens[i] = len(enc)
                        ids.append(rid)
                        group.append(g)
                        offset.append(off)
                    else:
                        self._pending.append(row)
        if not ids:
            return None
        return ReadBatch(
            codes=codes,
            lens=lens,
            ids=ids,
            group=np.asarray(group, dtype=np.int32),
            offset=np.asarray(offset, dtype=np.int32),
        )

    def _rows_for(self, rid: str, seq: bytes) -> list[tuple[str, np.ndarray, int]]:
        raw = np.frombuffer(seq, dtype=np.uint8)
        enc = _ENCODE_LUT[raw]
        # Non-ACGT bases in reads: `DnaString::from_dna_string` maps
        # unknown ASCII to code 0 ('A') (reference call site:
        # src/pseudoaligner.rs:450 [dep]).
        enc = np.where(enc == 255, 0, enc).astype(np.uint8)
        g = self._read_index
        self._read_index += 1
        L = self.max_len
        if len(enc) <= L:
            return [(rid, enc, g, 0)]
        if not self.segment_long:
            raise ValueError(
                f"read {rid!r} length {len(seq)} exceeds max_read_len={L} "
                "(enable segment_long)"
            )
        stride = L - self.window_overlap
        rows = []
        p = 0
        while True:
            rows.append((rid, enc[p : p + L], g, p))
            if p + L >= len(enc):
                break
            p = min(p + stride, len(enc) - L)
        return rows

    def _next_batch(self) -> ReadBatch | None:
        b, L = self.batch_size, self.max_len
        codes = np.zeros((b, L), dtype=np.uint8)
        lens = np.zeros(b, dtype=np.int32)
        ids: list[str] = []
        group: list[int] = []
        offset: list[int] = []

        def put(row):
            i = len(ids)
            rid, enc, g, off = row
            codes[i, : len(enc)] = enc
            lens[i] = len(enc)
            ids.append(rid)
            group.append(g)
            offset.append(off)

        while len(ids) < b and self._pending:
            put(self._pending.pop(0))
        while len(ids) < b:
            try:
                rid, seq = next(self._records)
            except StopIteration:
                break
            rows = self._rows_for(rid, seq)
            # keep all windows of one read in the same batch when possible
            if len(rows) > b - len(ids):
                self._pending.extend(rows)
                while len(ids) < b and self._pending:
                    put(self._pending.pop(0))
            else:
                for r in rows:
                    put(r)
        if not ids:
            return None
        return ReadBatch(
            codes=codes,
            lens=lens,
            ids=ids,
            group=np.asarray(group, dtype=np.int32),
            offset=np.asarray(offset, dtype=np.int32),
        )
