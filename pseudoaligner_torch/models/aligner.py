"""The Pseudoaligner serving surface on PyTorch.

Port of `pseudoaligner_tpu/models/aligner.py`: the index lives on a torch
device, each batch is packed on the host, copied in, mapped by
`map_batch_packed` (the CUDA kernels on a GPU, the plain PyTorch passes on
the CPU), and its compact outputs come back through pinned host buffers
while the host renders earlier batches.  Records are byte-identical to the
reference's.

The host-side NumPy helpers and the emit, paired-end, re-map and long-read
merge methods are copied from the reference unchanged; only the
device-touching parts are rewritten.  All three seed indexes (cuckoo,
bucket1, mphf) serve.  The full-output record path reads the device's
bitset EC intersection on transcriptomes of at most
`config.bitset_tx_threshold` transcripts and intersects class lists on
the host above it.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from .. import spans
from ..config import AlignerConfig
from ..index.image import IndexImage
from ..io.fastq import FastqReader, ReadBatch
from ..pipeline import DepthPipeline, prefetch_iter
from ..ops.map_kernel import (
    NATIVE_ERRORS,
    MapResult,
    device_index_from_image,
    map_batch_packed,
    pack_reads_host,
    upload,
)

# sentinel for invalid/padding EC ids in canonicalized signature rows
# (larger than any class id; int64 rows)
_SENT = np.int64(1) << 40


def _host(t) -> np.ndarray:
    """A result field as a host numpy array (waits for its device)."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _count_pinned(*tensors) -> None:
    """Count pinned host buffers allocated for one batch."""
    spans.count("pa.pinned_allocs", len(tensors))
    spans.count("pa.pinned_bytes", sum(t.nbytes for t in tensors))


def _csr_rows(flat: np.ndarray, start: np.ndarray, idxs: np.ndarray):
    """Select rows `idxs` of a CSR (flat, start) -> (sel_flat, sel_offs),
    fully vectorized (np.repeat positional trick)."""
    lens = np.diff(start)[idxs]
    offs = np.zeros(len(idxs) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    total = int(offs[-1])
    if total == 0:
        return np.zeros(0, flat.dtype), offs
    pos = np.arange(total, dtype=np.int64)
    pos += np.repeat(start[idxs] - offs[:-1], lens)
    return flat[pos], offs


def _fill_rows(dst_flat, dst_start, row_idxs, src_flat, src_offs):
    """Write src CSR rows into dst rows `row_idxs` (orders aligned)."""
    if len(row_idxs) == 0 or int(src_offs[-1]) == 0:
        return
    lens = np.diff(src_offs)
    pos = np.arange(int(src_offs[-1]), dtype=np.int64)
    pos += np.repeat(dst_start[row_idxs] - src_offs[:-1], lens)
    dst_flat[pos] = src_flat


def _group_by_packed(mat: np.ndarray, packed: np.ndarray):
    """(uniq_rows, inverse) via ONE argsort of a per-row int64 key."""
    m = len(packed)
    order = np.argsort(packed)
    sp = packed[order]
    head = np.ones(m, bool)
    head[1:] = sp[1:] != sp[:-1]
    inv = np.empty(m, np.int64)
    inv[order] = np.cumsum(head) - 1
    return mat[order][head], inv


def _group_rows(mat: np.ndarray):
    """Group identical rows -> (uniq_rows, inverse).  Group ids are
    deterministic but NOT promised to be in lexicographic order — every
    caller routes them through an inverse array, so only row identity
    matters.

    Fast paths: int16 rows of <=4 columns sort as ONE int64 bit-pattern
    view; wider integer rows whose columns fit 63 bits combined pack into
    one int64 key.  Anything else takes the lexsort path."""
    m = len(mat)
    if m == 0:
        return mat, np.zeros(0, np.int64)
    if (mat.ndim == 2 and 0 < mat.shape[1] <= 4
            and mat.dtype == np.int16):
        if mat.shape[1] == 4 and mat.flags.c_contiguous:
            m4 = mat
        else:
            m4 = np.full((m, 4), np.int16(-0x8000))
            m4[:, : mat.shape[1]] = mat
        return _group_by_packed(mat, m4.reshape(-1).view(np.int64))
    if (mat.ndim == 2 and 0 < mat.shape[1] <= 6
            and np.issubdtype(mat.dtype, np.integer)
            and mat.dtype.itemsize >= 4):
        lo = mat.min(axis=0).astype(np.int64)
        span = mat.max(axis=0).astype(np.int64) - lo + 1
        bits = [max(1, int(s - 1).bit_length()) for s in span]
        if sum(bits) <= 63:
            packed = np.zeros(m, np.int64)
            for c in range(mat.shape[1]):
                packed <<= bits[c]
                packed |= mat[:, c].astype(np.int64) - lo[c]
            return _group_by_packed(mat, packed)
    order = np.lexsort(mat.T[::-1])
    srt = mat[order]
    head = np.ones(m, bool)
    head[1:] = np.any(srt[1:] != srt[:-1], axis=1)
    inv = np.empty(m, np.int64)
    inv[order] = np.cumsum(head) - 1
    return srt[head], inv


def _canon_id_rows(vals: np.ndarray) -> np.ndarray:
    """[m, w] int64 id rows (invalid = _SENT) -> canonical form: each
    row ascending, distinct, _SENT-padded (two sorts + a dup mask)."""
    vals = np.sort(vals, axis=1)
    dup = np.zeros(vals.shape, bool)
    dup[:, 1:] = vals[:, 1:] == vals[:, :-1]
    return np.sort(np.where(dup, _SENT, vals), axis=1)


_ID_ESCAPE_RE = None  # compiled lazily; see _concat_ids_for_emit


def _concat_ids_for_emit(batch) -> tuple[bytes, np.ndarray]:
    """Concatenated id bytes + [n+1] int64 offsets for the native record
    emitters, with Rust-Debug escaping applied (src/pseudoaligner.rs:490).

    A batch built from raw id bytes already carries exactly this format
    when one regex scan finds no id that needs escaping; ids with escapes
    or non-ASCII take the per-id str path."""
    global _ID_ESCAPE_RE
    if _ID_ESCAPE_RE is None:
        import re

        # any non-ASCII byte routes through the escaper too: Rust
        # unicode-escapes non-printables and grapheme-extended chars
        _ID_ESCAPE_RE = (
            re.compile(r'[\\"\x00-\x1f\x7f]|[^\x00-\x7e]'),
            re.compile(rb'[\\"\x00-\x1f\x7f-\xff]'),
        )
    str_re, byte_re = _ID_ESCAPE_RE
    if getattr(batch, "_ids", None) is None and batch.ids_concat is not None:
        if byte_re.search(batch.ids_concat) is None:
            return batch.ids_concat, batch.id_offs
    ids = batch.ids
    joined = "".join(ids)
    if str_re.search(joined) is not None:
        ids = [_rust_debug_escape(s) for s in ids]
        joined = "".join(ids)
    concat = joined.encode()
    if len(concat) != len(joined):  # non-ASCII ids: per-id byte lengths
        id_lens = np.array([len(s.encode()) for s in ids], dtype=np.int64)
    else:
        id_lens = np.array([len(s) for s in ids], dtype=np.int64)
    id_offs = np.zeros(len(ids) + 1, dtype=np.int64)
    np.cumsum(id_lens, out=id_offs[1:])
    return concat, id_offs


# Rust `char::is_printable` treats these general categories as
# non-printable (library/core/src/unicode/printable.py: Cc Cf Cs Co Cn
# Zl Zp Zs, with U+0020 SPACE carved back out).
_RUST_NONPRINTABLE_CATS = frozenset(
    {"Cc", "Cf", "Cs", "Co", "Cn", "Zl", "Zp", "Zs"}
)
# Unicode Grapheme_Extend = Me + Mn + Other_Grapheme_Extend; the
# Other_Grapheme_Extend members that are NOT already non-printable (the
# Cf ones are) — Mc/Lm codepoints from PropList.txt.
_OTHER_GRAPHEME_EXTEND = frozenset(
    [0x09BE, 0x09D7, 0x0B3E, 0x0B57, 0x0BBE, 0x0BD7, 0x0CC2, 0x0CD5,
     0x0CD6, 0x0D3E, 0x0D57, 0x0DCF, 0x0DDF, 0x1B35, 0x302E, 0x302F,
     0xFF9E, 0xFF9F, 0x1133E, 0x11357, 0x114B0, 0x114BD, 0x115AF,
     0x11930, 0x1D165, 0x1D16E, 0x1D16F, 0x1D170, 0x1D171, 0x1D172]
)


def _rust_debug_escape(s: str) -> str:
    """Escape a read id like Rust `str`'s Debug impl (`escape_debug_ext`
    with escape_grapheme_extended=true, escape_single_quote=false,
    escape_double_quote=true) so map-record output stays byte-identical
    to `println!("{:?}", _)` on adversarial ids (src/pseudoaligner.rs:490).

    Beyond the ASCII specials, Rust unicode-escapes (a) grapheme-extended
    chars (Mn/Me + Other_Grapheme_Extend) and (b) non-printable chars
    (categories Cc/Cf/Cs/Co/Cn/Zl/Zp/Zs except SPACE), as `\\u{..}`
    lowercase hex."""
    import unicodedata

    out: list[str] = []
    for ch in s:
        o = ord(ch)
        if ch == "\0":
            out.append("\\0")
        elif ch == "\t":
            out.append("\\t")
        elif ch == "\r":
            out.append("\\r")
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\\":
            out.append("\\\\")
        elif ch == '"':
            out.append('\\"')
        elif o < 0x20 or o == 0x7F:
            out.append(f"\\u{{{o:x}}}")
        elif o < 0x80:
            out.append(ch)
        else:
            cat = unicodedata.category(ch)
            grapheme_ext = (
                cat in ("Mn", "Me") or o in _OTHER_GRAPHEME_EXTEND
            )
            if grapheme_ext or cat in _RUST_NONPRINTABLE_CATS:
                out.append(f"\\u{{{o:x}}}")
            else:
                out.append(ch)
    return "".join(out)


@dataclasses.dataclass
class ReadRecord:
    """Per-read mapping record — the reference's output tuple
    `(flag, read_id, eq_class, coverage)` (src/pseudoaligner.rs:453-462),
    with its flag predicate `coverage >= READ_COVERAGE_THRESHOLD &&
    eq_class.is_empty()` (src/pseudoaligner.rs:455)."""

    flag: bool
    read_id: str
    eq_class: list[int]
    coverage: int

    def format_reference_style(self) -> str:
        """Render exactly like Rust's `println!("{:?}", read_data)`."""
        flag = "true" if self.flag else "false"
        eq = "[" + ", ".join(str(x) for x in self.eq_class) + "]"
        rid = _rust_debug_escape(self.read_id)
        return f'({flag}, "{rid}", {eq}, {self.coverage})'


class Pseudoaligner:
    """Index on a torch device + the batched mapping engine.

    `device` is where the index lives and the step runs: "cuda" (the
    default; the CUDA kernels) or "cpu" (the plain PyTorch passes).  The
    TPU-only knobs of AlignerConfig (pool_overlap, walk_unroll,
    walk_straightline, left_compact, walk_split, walk_compact,
    seed_compact) are read and ignored; see ops/map_kernel.py."""

    def __init__(
        self,
        image: IndexImage,
        config: AlignerConfig | None = None,
        device="cuda",
        map_step=None,
        meta=None,
    ):
        """`map_step(codes, lens) -> MapResult` plugs an external engine
        under the serving surface; the index is then not built here, and
        `meta` must be the engine's."""
        with spans.span("pa.serve_init"):
            if config is None:
                config = AlignerConfig(k=image.k)
            if config.k != image.k:
                raise ValueError(f"config k={config.k} != index k={image.k}")
            self.device = torch.device(device)
            if self.device.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "device 'cuda' requested but "
                        "torch.cuda.is_available() is False; pass "
                        "device='cpu' for the plain PyTorch path")
                if self.device.index is None:
                    self.device = torch.device("cuda",
                                               torch.cuda.current_device())
            self.image = image
            self.config = config
            self._map_step = map_step
            if map_step is None:
                if meta is not None:
                    raise ValueError(
                        "meta is only used together with map_step")
                dev_np, self.meta = device_index_from_image(image, config)
                self.dev = upload(dev_np, self.device, serving=self.meta)
            else:
                if meta is None:
                    raise ValueError("map_step requires the engine's meta")
                self.meta = meta
            # host-side EC intersection memo for the CSR path
            self._ec_memo: dict[tuple[int, ...], list[int]] = {}
            # id(ec_distinct) -> (weakref, event, pinned dist, pinned cov) of
            # the compact outputs' device-to-host copies in flight
            self._fetches: dict[int, tuple] = {}

    def close(self) -> None:
        """Release the lazily-created worker pool and the re-map index."""
        pool = getattr(self, "_remap_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
            del self._remap_pool
        for attr in ("_remap_meta", "_remap_dev"):
            if hasattr(self, attr):
                delattr(self, attr)

    # ------------------------------------------------------------------
    # device step
    # ------------------------------------------------------------------

    def _step(self, meta, dev, codes: np.ndarray, lens: np.ndarray):
        """Pack on the host, copy to the device (pinned, non-blocking) and
        map."""
        packed = torch.from_numpy(
            pack_reads_host(np.asarray(codes, dtype=np.uint8)).view(np.int32))
        lens_t = torch.from_numpy(np.ascontiguousarray(lens, dtype=np.int32))
        if self.device.type == "cuda":
            packed, lens_t = packed.pin_memory(), lens_t.pin_memory()
            _count_pinned(packed, lens_t)
            packed = packed.to(self.device, non_blocking=True)
            lens_t = lens_t.to(self.device, non_blocking=True)
        return map_batch_packed(meta, dev, packed, lens_t)

    def map_batch_device(self, codes: np.ndarray, lens: np.ndarray) -> MapResult:
        """Map a [B, L] batch of base codes.  On a GPU the compact outputs
        start their copy to pinned host memory right away; emit_prepare
        waits on that copy's event."""
        if self._map_step is not None:
            return self._map_step(codes, lens)
        result = self._step(self.meta, self.dev, codes, lens)
        if self.device.type == "cuda" and self.meta.distinct_cap > 0:
            # each batch owns its pinned buffers and event: with
            # pipeline_depth batches in flight, no staging buffer is reused
            dist = torch.empty(result.ec_distinct.shape,
                               dtype=result.ec_distinct.dtype,
                               pin_memory=True)
            cov = torch.empty(result.coverage.shape,
                              dtype=result.coverage.dtype, pin_memory=True)
            _count_pinned(dist, cov)
            dist.copy_(result.ec_distinct, non_blocking=True)
            cov.copy_(result.coverage, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            key = id(result.ec_distinct)
            fetches = self._fetches
            # the entry drops itself when the result dies unconsumed
            ref = weakref.ref(result.ec_distinct,
                              lambda _r, k=key, f=fetches: f.pop(k, None))
            fetches[key] = (ref, ev, dist, cov)
        return result

    def _fetch_compact(self, result: MapResult):
        """(ec_distinct, coverage) of a compact result as numpy arrays."""
        ent = self._fetches.pop(id(result.ec_distinct), None)
        if ent is None:
            return _host(result.ec_distinct), _host(result.coverage)
        _ref, ev, dist, cov = ent
        ev.synchronize()
        return dist.numpy(), cov.numpy()

    # ------------------------------------------------------------------
    # host post-processing
    # ------------------------------------------------------------------

    def _ec_from_bits(self, bits_row: np.ndarray) -> list[int]:
        by = np.ascontiguousarray(bits_row).view(np.uint8)
        unpacked = np.unpackbits(by, bitorder="little")[: self.image.n_tx]
        return np.nonzero(unpacked)[0].tolist()

    def _ec_from_nodes(self, nodes: np.ndarray) -> list[int]:
        """Host CSR intersection — set-equivalent to
        src/pseudoaligner.rs:323-356."""
        img = self.image
        ec_ids = tuple(
            sorted(set(int(img.node_ec[n]) for n in nodes if n >= 0))
        )
        return self._ec_from_distinct(ec_ids)

    def _ec_from_distinct(self, ids: tuple[int, ...]) -> list[int]:
        """Materialize the EC list from distinct interned class ids
        (memoized host CSR intersection)."""
        hit = self._ec_memo.get(ids)
        if hit is not None:
            return hit
        img = self.image
        lists = sorted((img.ec_list(e) for e in ids), key=len)
        acc = lists[0]
        for other in lists[1:]:
            acc = np.intersect1d(acc, other, assume_unique=True)
            if len(acc) == 0:
                break
        out = [int(x) for x in acc]
        self._ec_memo[ids] = out
        return out

    def records_from_result(
        self, result: MapResult, batch: ReadBatch
    ) -> list[ReadRecord]:
        mapped = _host(result.mapped)
        cov = _host(result.coverage)
        n = batch.n_reads
        thresh = self.config.read_coverage_threshold

        if self.meta.distinct_cap > 0:
            # materialize each distinct EC signature once
            dist = _host(result.ec_distinct)[:n]
            uniq, inv = np.unique(dist, axis=0, return_inverse=True)
            inv = inv.reshape(-1)
            eq_of_sig: list = []
            for row in uniq:
                if row[-1] in (-2, -3):
                    eq_of_sig.append(None)  # overflow/capped -> exact re-map
                elif row[0] < 0:
                    eq_of_sig.append([])
                else:
                    # device emits raw push-order ids; dedup here
                    ids = tuple(sorted({int(x) for x in row if x >= 0}))
                    eq_of_sig.append(
                        self.image.ec_list(ids[0]).tolist()
                        if len(ids) == 1
                        else self._ec_from_distinct(ids)
                    )
            covl = cov.tolist()
            mappedl = mapped.tolist()
            overflow_rows = [
                i for i in range(n) if eq_of_sig[inv[i]] is None
            ]
            overflow_res = self._remap_rows(batch, overflow_rows)
            out = []
            for i, rid in enumerate(batch.ids):
                eq = eq_of_sig[inv[i]]
                if eq is None:
                    req, rcov = overflow_res[i]
                    eq = [int(x) for x in req]
                    c = rcov  # capped lanes have partial device coverage
                elif not mappedl[i]:
                    out.append(ReadRecord(False, rid, [], 0))
                    continue
                else:
                    c = covl[i]
                out.append(ReadRecord(c >= thresh and not eq, rid, eq, c))
            return out

        if self.meta.tx_words > 0:
            bits = _host(result.ec_bits)
        else:
            nodes = _host(result.nodes)
            n_nodes = _host(result.n_nodes)
        out = []
        for i, rid in enumerate(batch.ids):
            if not mapped[i]:
                out.append(ReadRecord(False, rid, [], 0))
                continue
            if self.meta.tx_words > 0:
                eq = self._ec_from_bits(bits[i])
            else:
                eq = self._ec_from_nodes(nodes[i, : n_nodes[i]])
            c = int(cov[i])
            out.append(ReadRecord(c >= thresh and len(eq) == 0, rid, eq, c))
        return out

    # ------------------------------------------------------------------
    # native batch emit (the serving fast path)
    # ------------------------------------------------------------------

    def emit_batch(self, result: MapResult, batch: ReadBatch,
                   tcc=None) -> bytes:
        """A whole batch's records, reference-style, through the native
        emitter (compact mode); updates `tcc` counts if given.  The
        synchronous form of emit_prepare + emit_finish: pipelined callers
        (emit_fastq) run the two phases a batch apart, so that the
        overflow re-map emit_prepare dispatches overlaps the next batch's
        device step."""
        return self.emit_finish(self.emit_prepare(result, batch, tcc))

    def emit_prepare(self, result: MapResult, batch: ReadBatch, tcc=None,
                     defer_group=False):
        """Phase 1: fetch compact outputs, dispatch the overflow re-map,
        group signatures and materialize their EC lists (cached).  Returns
        an opaque state for emit_finish.  With `defer_group=True` the
        grouping is left to `emit_prepare_group`."""
        n = batch.n_reads
        with spans.span("pa.prep.fetch"):
            dist, cov = self._fetch_compact(result)
        with spans.span("pa.prep.remap_dispatch"):
            cov = cov[:n].astype(np.int32)
            dist = dist[:n]
            # dispatch the overflow re-map first so it overlaps the host work
            flagged = (dist[:, -1] == -2) | (dist[:, -1] == -3)
            overflow_rows = np.nonzero(flagged)[0].tolist()
            remap_fut = self._remap_dispatch(batch, overflow_rows)
        st = {
            "batch": batch,
            "tcc": tcc,
            "n": n,
            "cov": cov,
            "dist": dist,
            "flagged": flagged,
            "overflow_rows": overflow_rows,
            "remap_fut": remap_fut,
        }
        return st if defer_group else self.emit_prepare_group(st)

    def emit_prepare_group(self, st):
        """Phase 1b (idempotent): signature grouping + EC-list
        materialization for a deferred emit_prepare state."""
        if "inv" in st:
            return st
        n = st["n"]
        dist = st["dist"]
        flagged = st["flagged"]
        with spans.span("pa.prep.group"):
            # most rows are single-class ([e, -1, ...]): group those on one
            # int column and only the multi-class minority by full rows
            # (flagged rows stay in the full-row group so their markers
            # survive)
            single = (
                (dist[:, 1] == -1) & ~flagged
                if dist.shape[1] >= 2
                else np.zeros(n, bool)
            )
            u1, inv1 = np.unique(dist[single, 0], return_inverse=True)
            multi = dist[~single]
            u2, inv2 = _group_rows(multi)
            inv = np.empty(n, dtype=np.int64)
            inv[single] = inv1
            inv[~single] = inv2 + len(u1)

        with spans.span("pa.prep.siglists"):
            # single-class groups are vectorized CSR slices; multi-class
            # groups are canonicalized and batch-intersected in C++;
            # overflow-marker groups stay None-equivalent (none_mask) and get
            # per-read overrides in emit_finish
            eo = np.asarray(self.image.ec_offsets, dtype=np.int64)
            et = np.asarray(self.image.ec_txs, dtype=np.uint32)
            m1, m2 = len(u1), len(u2)
            none_mask = np.zeros(m1 + m2, dtype=bool)
            ids1 = u1.astype(np.int64)
            n_ec = len(eo) - 1
            eo_pad = np.append(eo, eo[-1])  # row n_ec is empty
            flat1, offs1 = _csr_rows(
                et, eo_pad, np.where(ids1 >= 0, ids1, n_ec)
            )
            lens1 = np.diff(offs1)
            if m2:
                rowsm = u2.astype(np.int64)
                ovr2 = (rowsm[:, -1] == -2) | (rowsm[:, -1] == -3)
                none_mask[m1:] = ovr2
                vals = _canon_id_rows(np.where(rowsm >= 0, rowsm, _SENT))
                vals[ovr2] = _SENT  # overflow groups contribute nothing here
                flat2, lens2 = self._intersect_rows(vals)
            else:
                flat2 = np.zeros(0, np.uint32)
                lens2 = np.zeros(0, np.int64)

            sig_start = np.zeros(m1 + m2 + 1, dtype=np.int64)
            np.cumsum(np.concatenate([lens1, lens2]), out=sig_start[1:])
            sig_flat = np.concatenate([flat1, flat2])

        # drop the inputs only on success, then set the completion marker
        del st["dist"], st["flagged"]
        st["inv"] = inv
        st["none_mask"] = none_mask
        st["sig_start"] = sig_start
        st["sig_flat"] = sig_flat
        return st

    def emit_finish(self, state) -> bytes:
        """Phase 2: collect the overflow re-map, patch coverage and format
        via the signature-indirect native emitter."""
        from ..io import native as _native

        batch = state["batch"]
        tcc = state["tcc"]
        n = state["n"]
        cov = state["cov"]
        inv = state["inv"]
        none_mask = state["none_mask"]
        sig_start = state["sig_start"]
        sig_flat = state["sig_flat"]
        overflow_rows = state["overflow_rows"]

        with spans.span("pa.fin.remap_collect"):
            overflow_res = self._remap_collect(state["remap_fut"])
        with spans.span("pa.fin.patch"):
            overflow_eq = {i: r[0] for i, r in overflow_res.items()}
            for i in overflow_rows:
                cov[i] = overflow_res[i][1]  # capped lanes: exact coverage

            sig_of_read = np.where(none_mask[inv], np.int64(-1), inv)
            ovr_rows = np.asarray(overflow_rows, dtype=np.int64)
            ovr_start = np.zeros(len(ovr_rows) + 1, dtype=np.int64)
            if len(ovr_rows):
                np.cumsum(
                    np.array([len(overflow_eq[i]) for i in overflow_rows],
                             dtype=np.int64),
                    out=ovr_start[1:],
                )
            ovr_ids = (
                np.concatenate([overflow_eq[i] for i in overflow_rows])
                if len(ovr_rows)
                else np.zeros(0, np.uint32)
            )

            ids_concat, id_offs = _concat_ids_for_emit(batch)

            # per-transcript count deltas (the multi-process merge,
            # parallel/multihost.py): each record's classes count once, groups
            # sig_counts[g] per transcript of their list, overflow rows 1 each;
            # the ordered finish checkpoints them with the write offset
            tx_sink = state.get("tx_sink")
            if tx_sink is not None:
                gcounts = np.bincount(inv, minlength=len(none_mask))
                w = np.repeat(
                    np.where(none_mask, 0, gcounts).astype(np.int64),
                    np.diff(sig_start),
                )
                tx_sink.append((sig_flat[: int(sig_start[-1])], w))
                if len(ovr_ids):
                    tx_sink.append(
                        (ovr_ids, np.ones(len(ovr_ids), dtype=np.int64)))

            if tcc is not None:
                tcc.n_reads += n
                sig_counts = np.bincount(inv, minlength=len(none_mask))
                for si in sig_counts.nonzero()[0]:
                    if none_mask[si]:
                        continue
                    tcc.add_group(sig_flat[sig_start[si] : sig_start[si + 1]],
                                  int(sig_counts[si]))
                for i in overflow_rows:
                    tcc.add_group(overflow_eq[i].tolist())

        with spans.span("pa.fin.emit"):
            data = _native.emit_records_sig(
                cov, self.config.read_coverage_threshold, ids_concat, id_offs,
                sig_of_read, sig_start, sig_flat, ovr_rows, ovr_start, ovr_ids,
            )
        return data

    def emit_fastq(self, path: str, out, skip_reads: int = 0, tcc=None,
                   progress_cb=None, batch_iter=None, count_cb=None,
                   ticker=None):
        """Stream a FASTQ and write reference-style records to `out` (a
        binary stream) via the native emitter.  Batches holding segmented
        long reads take the record path.  Returns (n_reads, n_flagged).

        `batch_iter` replaces the FastqReader of `path` with an iterator of
        ReadBatches (the per-process batch stride of
        parallel/multihost.py); `path` and `skip_reads` are then unused.
        `count_cb(n_batch_reads, deltas)` fires at each batch's ordered
        finish, after its records reached `out`: `deltas` is a list of
        (tx_ids, weights), that batch's per-transcript counts, so a
        checkpoint taken in the callback matches the write offset.
        `ticker(n_reads, n_flagged)` fires after each batch's ordered
        finish (see cli.make_ticker)."""
        if batch_iter is None:
            reader = FastqReader(
                path,
                batch_size=self.config.batch_size,
                max_len=self.config.max_read_len,
                segment_long=True,
                window_overlap=self.config.k - 1,
                skip_reads=skip_reads,
            )
        else:
            reader = batch_iter
        n_reads = 0
        n_flagged = 0
        any_batch = False
        merge_state = None  # incremental window-merge carry across batches
        fb_sink: list = []  # record-path count deltas (fallback batches)

        def put_record(rec):
            nonlocal n_reads, n_flagged
            out.write(rec.format_reference_style().encode() + b"\n")
            if tcc is not None:
                tcc.add(rec.eq_class, mapped=rec.coverage > 0)
            if count_cb is not None and rec.eq_class:
                fb_sink.append((np.asarray(rec.eq_class, dtype=np.int64),
                                np.ones(len(rec.eq_class), dtype=np.int64)))
            n_reads += 1
            n_flagged += rec.flag

        # DepthPipeline (pipeline.py): the compact-output fetch
        # (emit_prepare) and the overflow re-map wait (emit_finish) are
        # each deferred pipeline_depth batches.  The record-path fallback
        # (segmented long reads, cross-batch groups) drains the prepared
        # stage first, preserving output order.
        def render(st_n):  # ordered single-worker pool (pipeline.py)
            st, n = st_n
            st = self.emit_prepare_group(st)
            return self.emit_finish(st), n, st.get("tx_sink")

        def finish(data_n):
            nonlocal n_reads, n_flagged
            data, n, sink = data_n
            out.write(data)
            n_reads += n
            n_flagged += int(data.startswith(b"(true")) + int(
                data.count(b"\n(true")
            )
            if count_cb is not None:
                count_cb(n, sink or [])
            if ticker is not None:
                ticker(n_reads, n_flagged)

        def prepare(item, nxt):
            nonlocal merge_state
            res, batch = item
            nb = nxt[1] if nxt is not None else None
            next_first_group = (int(nb.group[0])
                                if nb is not None and nb.group is not None
                                else None)
            grp = batch.group
            n = batch.n_reads
            simple = (
                self.meta.distinct_cap > 0
                and merge_state is None
                and grp is not None
                and len(np.unique(grp)) == n
                and (next_first_group is None
                     or int(grp[n - 1]) != next_first_group)
            )
            if simple:
                st = self.emit_prepare(res, batch, tcc=tcc,
                                       defer_group=True)
                if count_cb is not None:
                    st["tx_sink"] = []
                return (st, n)
            pipe.drain_prepared()
            n_before = n_reads
            for rec, g, end in self._batch_rows(res, batch):
                merge_state, done = self._merge_push(merge_state, rec, g, end)
                if done is not None:
                    put_record(done)
            if next_first_group is None or (
                merge_state is not None and merge_state[0] != next_first_group
            ):
                if merge_state is not None:
                    put_record(
                        self._finalize_merged(merge_state[1], merge_state[2])
                    )
                    merge_state = None
            if count_cb is not None:
                # record-path batches checkpoint per batch too (a window
                # merge carried past the boundary counts with the batch
                # that finalizes it)
                count_cb(n_reads - n_before, list(fb_sink))
                fb_sink.clear()
            if ticker is not None:
                ticker(n_reads, n_flagged)
            return None

        pipe = DepthPipeline(self.config.pipeline_depth, prepare, finish,
                             render=render)
        pf = prefetch_iter(iter(reader))
        try:
            for batch in pf:
                any_batch = True
                res = self.map_batch_device(batch.codes, batch.lens)
                pipe.push((res, batch))
                if progress_cb is not None:
                    progress_cb(n_reads)
            pipe.close()
        except BaseException:
            pipe.abort()  # drop queued work; no orphan render tasks
            raise
        finally:
            pf.close()
        if any_batch and progress_cb is not None:
            progress_cb(n_reads)
        return n_reads, n_flagged

    def _host_mapper(self):
        """Native scalar mapper (bit-exact with the golden oracle), lazily
        constructed; None when the toolchain is unavailable."""
        if not hasattr(self, "_host_mapper_inst"):
            try:
                from ..ops.native import HostMapper

                self._host_mapper_inst = HostMapper(self.image)
            except NATIVE_ERRORS:
                self._host_mapper_inst = None
        return self._host_mapper_inst

    def _remap_dispatch(self, batch: ReadBatch, rows: list[int]):
        """Start the exact re-map of the flagged overflow reads.

        Preferred path: the native host mapper on a background thread,
        overlapped with the device.  Without a host toolchain the device
        re-maps them in uncapped full-output mode.  Returns an opaque
        handle for _remap_collect."""
        if not rows:
            return None
        mapper = self._host_mapper()
        if mapper is not None:
            codes = np.ascontiguousarray(
                np.asarray(batch.codes, dtype=np.uint8)[rows]
            )
            lens = np.asarray(batch.lens, dtype=np.int32)[rows]
            if not hasattr(self, "_remap_pool"):
                from concurrent.futures import ThreadPoolExecutor

                self._remap_pool = ThreadPoolExecutor(max_workers=1)

            def run(rows=rows, codes=codes, lens=lens):
                cov, _mm, nodes, nn = mapper.map_reads(
                    codes, lens, self.config.allowed_mismatches,
                    self.config.left_extend_fraction,
                )
                eqs = self._eq_rows_from_nodes(
                    np.asarray(nodes), np.asarray(nn)
                )
                return {
                    i: (eqs[j], int(cov[j])) for j, i in enumerate(rows)
                }

            return ("host", rows, self._remap_pool.submit(run))
        if not hasattr(self, "_remap_meta"):
            if hasattr(self, "dev"):
                base_meta, self._remap_dev = self.meta, self.dev
            else:
                # map_step engines carry no index here; build one for
                # this rare exact re-map
                dev_np, base_meta = device_index_from_image(
                    self.image, self.config)
                self._remap_dev = upload(dev_np, self.device,
                                         serving=base_meta)
            # uncapped and exact: the node buffer is decoupled from the
            # serving meta's (which may be as small as the caps allow)
            self._remap_meta = dataclasses.replace(
                base_meta, distinct_cap=0, tx_words=0, max_walk_iters=0,
                max_left_iters=0,
                max_nodes=max(base_meta.max_nodes, 2 * base_meta.read_len),
            )
        B2 = 2048
        L = self.meta.read_len
        futures = []
        for c0 in range(0, len(rows), B2):
            chunk = rows[c0 : c0 + B2]
            codes = np.zeros((B2, L), dtype=np.uint8)
            lens = np.zeros(B2, dtype=np.int32)
            codes[: len(chunk)] = np.asarray(batch.codes)[chunk]
            lens[: len(chunk)] = np.asarray(batch.lens)[chunk]
            futures.append((chunk, self._step(self._remap_meta,
                                              self._remap_dev, codes, lens)))
        return futures

    def _intersect_rows(self, vals: np.ndarray):
        """Canonical (ascending, _SENT-padded) [m, w] EC-id rows ->
        (flat uint32, lens int64): each row's intersected transcript list.
        C++ batch intersection with a memoized per-row python fallback."""
        m = len(vals)
        try:
            from ..ops.native import intersect_ecs

            flat, offs = intersect_ecs(
                vals, self.image.ec_offsets, self.image.ec_txs, int(_SENT)
            )
            return flat, np.diff(offs)
        except NATIVE_ERRORS:
            parts = []
            lens = np.zeros(m, np.int64)
            for j, row in enumerate(vals):
                ids = tuple(int(x) for x in row[row < _SENT])
                if not ids:
                    continue
                eq = (
                    self.image.ec_list(ids[0])
                    if len(ids) == 1
                    else self._ec_from_distinct(ids)
                )
                parts.append(np.asarray(eq, dtype=np.uint32))
                lens[j] = len(parts[-1])
            flat = (
                np.concatenate(parts) if parts else np.zeros(0, np.uint32)
            )
            return flat, lens

    def _eq_rows_from_nodes(self, nodes: np.ndarray, nn: np.ndarray):
        """Vectorized [n, cap] visited-node rows -> list of EC arrays:
        canonicalize each row's distinct EC-id set, group identical rows,
        and batch-intersect each distinct signature once."""
        n = len(nn)
        if n == 0:
            return []
        with spans.span("pa.eqrows.canon"):
            ec = self.image.node_ec
            cap = max(1, int(nn.max()))
            nodes = nodes[:, :cap]
            mask = np.arange(cap)[None, :] < nn[:, None]
            vals = _canon_id_rows(
                np.where(
                    mask & (nodes >= 0),
                    ec[np.clip(nodes, 0, None)].astype(np.int64),
                    _SENT,
                )
            )
            # trim to the widest distinct-id count, then let narrow rows take
            # _group_rows' packed-int64 fast path
            width = max(1, int((vals < _SENT).sum(axis=1).max()))
            vals = vals[:, :width]
            bound = np.int64(len(self.image.ec_offsets))
            uniq, gid = _group_rows(np.where(vals == _SENT, bound, vals))
            sv_head = np.where(uniq == bound, _SENT, uniq)
        with spans.span("pa.eqrows.mats"):
            flat, lens = self._intersect_rows(sv_head)
            offs = np.zeros(len(lens) + 1, np.int64)
            np.cumsum(lens, out=offs[1:])
            mats = [flat[offs[i] : offs[i + 1]] for i in range(len(lens))]
        return [mats[g] for g in gid]

    def _remap_collect(self, futures) -> dict:
        """Harvest _remap_dispatch results -> {row: (eq array, coverage)}."""
        out: dict[int, tuple] = {}
        if not futures:
            return out
        if isinstance(futures, tuple) and futures[0] == "host":
            return futures[2].result()
        for chunk, res in futures:
            nodes = _host(res.nodes)
            nn = _host(res.n_nodes)
            cov = _host(res.coverage)
            eqs = self._eq_rows_from_nodes(nodes[: len(chunk)],
                                           nn[: len(chunk)])
            for j, i in enumerate(chunk):
                out[i] = (eqs[j], int(cov[j]))
        return out

    def _remap_rows(self, batch: ReadBatch, rows: list[int]) -> dict:
        """Synchronous exact re-map (dispatch + collect)."""
        return self._remap_collect(self._remap_dispatch(batch, rows))

    # ------------------------------------------------------------------
    # end-to-end streaming
    # ------------------------------------------------------------------

    def map_fastq(self, path: str, skip_reads: int = 0):
        """Stream a FASTQ file; yields ReadRecord per read, in file order.

        Reads longer than the batch width are segmented into overlapping
        windows on the host and their window results merged (EC =
        intersection of mapped windows' classes; coverage summed, capped
        at read length).  skip_reads: resume — skip the first N reads."""
        reader = FastqReader(
            path,
            batch_size=self.config.batch_size,
            max_len=self.config.max_read_len,
            segment_long=True,
            window_overlap=self.config.k - 1,
            skip_reads=skip_reads,
        )
        yield from self._merge_windows(self._stream_batches(reader))

    def _stream_batches(self, reader):
        """Double-buffered device execution; yields (record, group, end)."""
        pending = None
        for batch in reader:
            res = self.map_batch_device(batch.codes, batch.lens)
            if pending is not None:
                yield from self._batch_rows(*pending)
            pending = (res, batch)
        if pending is not None:
            yield from self._batch_rows(*pending)

    def _batch_rows(self, res, batch):
        recs = self.records_from_result(res, batch)
        group = batch.group
        offset = batch.offset
        for i, rec in enumerate(recs):
            g = int(group[i]) if group is not None else i
            off = int(offset[i]) if offset is not None else 0
            yield rec, g, off + int(batch.lens[i])

    def _merge_push(self, state, rec, g, end):
        """Incremental window merger: push one row, return (state, done)
        where done is a finalized ReadRecord or None."""
        from ..golden import intersect

        if state is None:
            return (g, rec, end), None
        cg, crec, cend = state
        if g != cg:
            return (g, rec, end), self._finalize_merged(crec, cend)
        if rec.coverage and crec.coverage:
            eq = intersect(list(crec.eq_class), rec.eq_class)
        elif rec.coverage:
            eq = rec.eq_class
        else:
            eq = crec.eq_class
        merged = ReadRecord(False, crec.read_id, eq,
                            crec.coverage + rec.coverage)
        return (cg, merged, max(cend, end)), None

    def _merge_windows(self, rows):
        """Merge per-window records of segmented long reads."""
        state = None
        for rec, g, end in rows:
            state, done = self._merge_push(state, rec, g, end)
            if done is not None:
                yield done
        if state is not None:
            yield self._finalize_merged(state[1], state[2])

    def _finalize_merged(self, rec: ReadRecord, total_len: int) -> ReadRecord:
        cov = min(rec.coverage, total_len)
        flag = (cov >= self.config.read_coverage_threshold
                and len(rec.eq_class) == 0)
        return ReadRecord(flag, rec.read_id, rec.eq_class, cov)

    def emit_fastq_paired(self, path1: str, path2: str, out,
                          progress_cb=None, ticker=None) -> int:
        """Paired-end serving fast path: BOTH mates ride one device batch
        (mate1 in rows [0, h), mate2 in [h, 2h), h = batch_size // 2) —
        one dispatch, one transfer, one shared signature table and one
        overflow re-map per batch pair instead of two of each.  Per-read
        records are rendered by the native signature-indirect emitter
        with fragment ECs intersected once per distinct (case, sig, sig)
        group in C++ (pa_intersect_pairs).  Record-identical to
        map_fastq_paired; returns the read count."""
        if self.meta.distinct_cap == 0:
            # full-debug-output mode has no compact signatures: fall back
            # to the record path instead of an IndexError on the
            # zero-width ec_distinct (emit_fastq and the CLI gate the
            # same way)
            n = nf = 0
            for rec in self.map_fastq_paired(path1, path2):
                out.write(rec.format_reference_style().encode() + b"\n")
                n += 1
                nf += rec.flag
                if ticker is not None:
                    ticker(n, nf)
                if progress_cb is not None:
                    progress_cb(n)
            self._paired_emitted = n
            return n
        bs, L = self.config.batch_size, self.config.max_read_len
        h = max(1, bs // 2)
        r1 = FastqReader(path1, h, L)
        r2 = FastqReader(path2, h, L)
        self._paired_emitted = 0
        it1, it2 = iter(r1), iter(r2)

        # depth-D deferral on both waits (pipeline.py): the compact-output
        # fetch and the re-map wait run pipeline_depth combined batches late
        def prepare(item, _nxt):
            res, comb, bb1, n1 = item
            return (self.emit_prepare(res, comb, defer_group=True),
                    bb1, n1)

        def render(st):
            grouped = self.emit_prepare_group(st[0])
            return self.emit_finish_paired(grouped, st[1], st[2]), st[2]

        n_true = 0

        def finish(data_n):
            # the durable count advances here, after the ordered write —
            # on the render thread it would run ahead of what is flushed
            # (crash-safe progress contract)
            nonlocal n_true
            data, n1 = data_n
            out.write(data)
            self._paired_emitted += n1
            if progress_cb is not None:
                progress_cb(self._paired_emitted)
            if ticker is not None:
                n_true += int(data.startswith(b"(true")) + int(
                    data.count(b"\n(true")
                )
                ticker(self._paired_emitted, n_true)

        pipe = DepthPipeline(self.config.pipeline_depth, prepare, finish,
                             render=render)

        def _pair_gen():
            while True:
                a = next(it1, None)
                b = next(it2, None)
                yield (a, b)
                if a is None and b is None:
                    return

        pairs = prefetch_iter(_pair_gen())
        try:
            return self._emit_paired_loop(pairs, pipe, h, r1, r2)
        except BaseException:
            pipe.abort()  # drop queued work; no orphan render tasks
            raise
        finally:
            pairs.close()

    def _emit_paired_loop(self, pairs, pipe, h, rdr1=None, rdr2=None):
        def _raw_ids(b):
            """(concat bytes, [<=h+1] offsets) padded to h rows so the
            combined batch always spans 2h rows (tail batches)."""
            if getattr(b, "_ids", None) is None and b.ids_concat is not None:
                concat, o = b.ids_concat, b.id_offs
            else:
                enc = [s.encode() for s in b.ids]
                o = np.zeros(len(enc) + 1, np.int64)
                np.cumsum([len(x) for x in enc], out=o[1:])
                concat = b"".join(enc)
            if len(o) - 1 < h:
                o = np.concatenate(
                    [o, np.full(h - (len(o) - 1), o[-1], np.int64)]
                )
            return concat, o

        while True:
            with spans.span("pa.pread"):
                b1, b2 = next(pairs)
            # whole-batch mismatches must error too (zip would silently
            # drop the longer file's tail)
            if (b1 is None) != (b2 is None) or (
                b1 is not None and b1.n_reads != b2.n_reads
            ):
                # a short mate may be a stashed gz corruption error
                # (deliver-then-error) — attribute it, don't report a
                # misleading pairing mismatch
                for rdr in (rdr1, rdr2):
                    err = (rdr.pending_error()
                           if rdr is not None else None)
                    if err is not None:
                        raise err
                raise ValueError("paired FASTQs have different read counts")
            if b1 is not None:
                with spans.span("pa.pcombine"):
                    codes = np.concatenate([b1.codes, b2.codes], axis=0)
                    lens = np.concatenate([b1.lens, b2.lens])
                    # record ids come from b1 (emit_finish_paired) and the
                    # remap path reads only codes/lens: the combined batch
                    # needs just its row count, so the ids are not joined
                    _, o1 = _raw_ids(b1)
                    _, o2 = _raw_ids(b2)
                    combined = ReadBatch(
                        codes=codes, lens=lens, ids_concat=b"",
                        id_offs=np.concatenate([o1, o2[1:] + o1[-1]]),
                    )
                fut = self.map_batch_device(codes, lens)
            if b1 is None:
                break
            pipe.push((fut, combined, b1, b1.n_reads))
        pipe.close()
        return self._paired_emitted

    def emit_finish_paired(self, st, b1, n1) -> bytes:
        """Phase 2 for one paired batch (semantics of _paired_rows:
        both mates mapped -> EC intersection, one mapped -> its set,
        coverage summed, ids from R1).  Both mates rode ONE device batch:
        pair i is rows (i, h + i) of the combined state, sharing one
        signature table and one overflow-remap dict."""
        from ..golden import intersect as _gx
        from ..io import native as _native

        h = st["n"] // 2
        with spans.span("pa.pfin.remap_collect"):
            ov = self._remap_collect(st["remap_fut"])
        with spans.span("pa.pfin.group"):
            cov_all = st["cov"]
            for i in st["overflow_rows"]:
                cov_all[i] = ov[i][1]
            cov1 = cov_all[:n1]
            cov2 = cov_all[h : h + n1]
            cov = cov1 + cov2
            inv = st["inv"]
            inv1 = inv[:n1]
            inv2 = inv[h : h + n1]
            none_mask = st["none_mask"]
            sf, ss = st["sig_flat"], st["sig_start"]
            has_ovr = none_mask[inv1] | none_mask[inv2]
            m1 = cov1 > 0
            m2 = cov2 > 0
            case = m1.astype(np.int64) * 2 + m2.astype(np.int64)
            key1 = np.where(m1, inv1, -1)
            key2 = np.where(m2, inv2, -1)
            simple = ~has_ovr
            uk, kinv = _group_rows(
                np.stack([case, key1, key2], axis=1)[simple])
        with spans.span("pa.pfin.intersect"):
            U = len(uk)
            c_u, g1_u, g2_u = uk[:, 0], uk[:, 1], uk[:, 2]
            both = c_u == 3
            only1 = c_u == 2
            only2 = c_u == 1
            lens_u = np.zeros(U, np.int64)
            flat3 = np.zeros(0, np.uint32)
            offs3 = np.zeros(1, np.int64)
            if both.any():
                fa, oa = _csr_rows(sf, ss, g1_u[both])
                fb, ob = _csr_rows(sf, ss, g2_u[both])
                try:
                    from ..ops.native import intersect_pairs

                    flat3, offs3 = intersect_pairs(fa, oa, fb, ob)
                except NATIVE_ERRORS:
                    parts = []
                    nb = int(both.sum())
                    offs3 = np.zeros(nb + 1, np.int64)
                    for j in range(nb):
                        eq = _gx(
                            [int(x) for x in fa[oa[j] : oa[j + 1]]],
                            [int(x) for x in fb[ob[j] : ob[j + 1]]],
                        )
                        parts.append(np.asarray(eq, np.uint32))
                        offs3[j + 1] = offs3[j] + len(parts[-1])
                    flat3 = (
                        np.concatenate(parts) if parts
                        else np.zeros(0, np.uint32)
                    )
                lens_u[both] = np.diff(offs3)
            lens_u[only1] = np.diff(ss)[g1_u[only1]]
            lens_u[only2] = np.diff(ss)[g2_u[only2]]
            sig_start = np.zeros(U + 1, np.int64)
            np.cumsum(lens_u, out=sig_start[1:])
            sig_flat = np.empty(int(sig_start[-1]), np.uint32)
            _fill_rows(sig_flat, sig_start, np.nonzero(both)[0], flat3, offs3)
            for mask, gu in ((only1, g1_u), (only2, g2_u)):
                idxs = np.nonzero(mask)[0]
                if len(idxs):
                    src_flat, src_offs = _csr_rows(sf, ss, gu[idxs])
                    _fill_rows(sig_flat, sig_start, idxs, src_flat, src_offs)

            sig_of_read = np.full(n1, -1, np.int64)
            sig_of_read[simple] = kinv

        with spans.span("pa.pfin.overrides"):
            # override rows (either mate -2/-3-flagged): each mate's resolved
            # EC lists assemble as CSR arrays (flagged mate -> its remap list,
            # clean mapped mate -> its signature row); both-mapped rows then
            # batch through ONE C++ intersect_pairs call and single-mate rows
            # bulk-copy — no per-row python list handling
            ovr_rows = np.nonzero(has_ovr)[0].astype(np.int64)
            R = len(ovr_rows)

            def _mate_csr(row_off, invm, m):
                """CSR of each override row's resolved list for one mate
                (global combined-batch row = pair row + row_off)."""
                g = invm[ovr_rows]
                mapped = m[ovr_rows]
                from_ov = none_mask[g] & mapped
                from_sig = mapped & ~none_mask[g]
                lens = np.zeros(R, np.int64)
                lens[from_sig] = np.diff(ss)[g[from_sig]]
                ov_lists = [
                    np.asarray(ov[int(i) + row_off][0], np.uint32)
                    for i in ovr_rows[from_ov]
                ]
                lens[from_ov] = [len(x) for x in ov_lists]
                offs = np.zeros(R + 1, np.int64)
                np.cumsum(lens, out=offs[1:])
                flat = np.empty(int(offs[-1]), np.uint32)
                sflat, soffs = _csr_rows(sf, ss, g[from_sig])
                _fill_rows(flat, offs, np.nonzero(from_sig)[0], sflat, soffs)
                if ov_lists:
                    ooffs = np.zeros(len(ov_lists) + 1, np.int64)
                    np.cumsum(lens[from_ov], out=ooffs[1:])
                    _fill_rows(flat, offs, np.nonzero(from_ov)[0],
                               np.concatenate(ov_lists), ooffs)
                return flat, offs, mapped

            ovr_start = np.zeros(R + 1, np.int64)
            ovr_ids = np.zeros(0, np.uint32)
            if R:
                fa_, oa_, map1 = _mate_csr(0, inv1, m1)
                fb_, ob_, map2 = _mate_csr(h, inv2, m2)
                both_r = map1 & map2
                a_only = map1 & ~map2
                b_only = map2 & ~map1
                out_lens = np.zeros(R, np.int64)
                out_lens[a_only] = np.diff(oa_)[a_only]
                out_lens[b_only] = np.diff(ob_)[b_only]
                flat_o = np.zeros(0, np.uint32)
                offs_o = np.zeros(1, np.int64)
                if both_r.any():
                    bidx = np.nonzero(both_r)[0]
                    fa, oa = _csr_rows(fa_, oa_, bidx)
                    fb, ob = _csr_rows(fb_, ob_, bidx)
                    try:
                        from ..ops.native import intersect_pairs

                        flat_o, offs_o = intersect_pairs(fa, oa, fb, ob)
                    except NATIVE_ERRORS:
                        parts = []
                        offs_o = np.zeros(len(bidx) + 1, np.int64)
                        for t in range(len(bidx)):
                            eq = _gx(
                                [int(x) for x in fa[oa[t] : oa[t + 1]]],
                                [int(x) for x in fb[ob[t] : ob[t + 1]]],
                            )
                            parts.append(np.asarray(eq, np.uint32))
                            offs_o[t + 1] = offs_o[t] + len(parts[-1])
                        flat_o = (np.concatenate(parts) if parts
                                  else np.zeros(0, np.uint32))
                    out_lens[both_r] = np.diff(offs_o)
                np.cumsum(out_lens, out=ovr_start[1:])
                ovr_ids = np.empty(int(ovr_start[-1]), np.uint32)
                _fill_rows(ovr_ids, ovr_start, np.nonzero(both_r)[0],
                           flat_o, offs_o)
                for mask, f_, o_ in ((a_only, fa_, oa_), (b_only, fb_, ob_)):
                    idxs = np.nonzero(mask)[0]
                    if len(idxs):
                        src_flat, src_offs = _csr_rows(f_, o_, idxs)
                        _fill_rows(ovr_ids, ovr_start, idxs, src_flat,
                                   src_offs)

        with spans.span("pa.pfin.emit"):
            ids_concat, id_offs = _concat_ids_for_emit(b1)
            out = _native.emit_records_sig(
                cov, self.config.read_coverage_threshold, ids_concat, id_offs,
                sig_of_read, sig_start, sig_flat, ovr_rows, ovr_start, ovr_ids,
            )
        return out

    def map_fastq_paired(self, path1: str, path2: str):
        """Paired-end mapping: both mates are mapped
        and their equivalence classes intersected — the compatible set for
        the fragment.  If only one mate maps, its class is used; if
        neither maps, the pair is unmapped.  Coverage is summed.

        The reference has no paired mode (single FASTQ only,
        src/bin/pseudoaligner.rs:28); semantics follow kallisto's
        paired-end EC intersection.

        Batched fast path: both mates' device steps for the NEXT batch pair
        are dispatched before the current pair's host post-processing (the
        same double-buffer pattern as map_fastq), and pair intersections
        are memoized by (eq_a, eq_b) signature — mate signatures repeat
        heavily, so almost every pair is a dict hit.
        """
        r1 = FastqReader(path1, self.config.batch_size, self.config.max_read_len)
        r2 = FastqReader(path2, self.config.batch_size, self.config.max_read_len)
        it1, it2 = iter(r1), iter(r2)
        pending = None
        pair_memo: dict = {}
        while True:
            b1 = next(it1, None)
            b2 = next(it2, None)
            if (b1 is None) != (b2 is None) or (
                b1 is not None and b1.n_reads != b2.n_reads
            ):
                for rdr in (r1, r2):  # attribute stashed gz corruption
                    err = rdr.pending_error()
                    if err is not None:
                        raise err
                raise ValueError("paired FASTQs have different read counts")
            if b1 is None:
                break
            res1 = self.map_batch_device(b1.codes, b1.lens)
            res2 = self.map_batch_device(b2.codes, b2.lens)
            if pending is not None:
                yield from self._paired_rows(*pending, pair_memo)
            pending = (res1, res2, b1, b2)
        if pending is not None:
            yield from self._paired_rows(*pending, pair_memo)

    def _paired_rows(self, res1, res2, b1, b2, pair_memo: dict):
        from ..golden import intersect

        recs1 = self.records_from_result(res1, b1)
        recs2 = self.records_from_result(res2, b2)
        thresh = self.config.read_coverage_threshold
        for a, b in zip(recs1, recs2):
            cov = a.coverage + b.coverage
            if a.coverage and b.coverage:
                key = (tuple(a.eq_class), tuple(b.eq_class))
                eq = pair_memo.get(key)
                if eq is None:
                    eq = intersect(list(a.eq_class), b.eq_class)
                    pair_memo[key] = eq
                eq = list(eq)  # records must not share the memo's list
            elif a.coverage:
                eq = a.eq_class
            elif b.coverage:
                eq = b.eq_class
            else:
                eq = []
            flag = cov >= thresh and len(eq) == 0
            yield ReadRecord(flag, a.read_id, eq, cov)
