"""Single-cell 10x stream: barcode/UMI-tagged reads -> per-cell TCC matrix.

BASELINE config 4 (alevin-style; Srivastava et al., cited at the
reference's README.md:13-15).  R1 carries cell barcode + UMI, R2 the cDNA
fragment.  R2 is pseudoaligned on device; per (cell, equivalence-class)
molecule counts are UMI-deduplicated.  The reference repo has no
single-cell pipeline (it is the pseudoalignment core such a pipeline would
sit on); this module is that workload's realization (a copy of
`pseudoaligner_tpu/singlecell.py`, with R2 mapped by the port).

Output: a Matrix-Market-style sparse matrix (cells x equivalence classes,
distinct-UMI counts) plus barcodes.tsv and the EC definition table.

Barcode handling follows the CellRanger/alevin convention: with a
whitelist, exact matches are accepted and non-matching barcodes are
corrected to a whitelist entry iff exactly one 1-Hamming-distance
candidate is on the list (a single N counts as a mismatch position);
ambiguous or distant barcodes are dropped.  Without a whitelist, the
pipeline knee-calls abundant barcodes from the molecule-count curve and
folds each uncalled barcode's molecules into the unique called barcode
at Hamming distance 1 (CellCounts.correct_barcodes) — the same
two-stage convention alevin uses when no external list is given.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass, field

import numpy as np

from .io.fastq import read_fastq_records
from .models.aligner import Pseudoaligner

_BASE_CODE = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T


def _encode_bc(seq: bytes):
    """2-bit encode a barcode; returns (code, n_pos) where n_pos is the
    single N/non-ACGT position (-1 if none), or None if >1 such position."""
    code = 0
    n_pos = -1
    for i, b in enumerate(seq):
        c = _BASE_CODE.get(b)
        if c is None:
            if n_pos >= 0:
                return None
            n_pos = i
            c = 0
        code = (code << 2) | c
    return code, n_pos


def _decode_2bit(code: int, width: int) -> str:
    """Big-endian 2-bit-packed ACGT decode — the single inverse of
    `_encode_bc`'s packing convention (shared by Whitelist and the
    batched count path)."""
    return "".join(
        "ACGT"[(code >> (2 * (width - 1 - i))) & 3] for i in range(width)
    )


def _umi_token(umi: str):
    """Canonical dict token for a UMI: the big-endian 2-bit packed int
    for pure-ACGT (int order == string order at fixed length, and the
    batched path's packed keys ARE this token — no decode round trip),
    else the string itself (N/lowercase, the face-value side path).
    Both count paths tokenize identically, so pools merge correctly."""
    code = 0
    for ch in umi:
        v = _BASE_CODE.get(ord(ch))
        if v is None:
            return umi
        code = (code << 2) | v
    return code


class Whitelist:
    """Known-barcode list with 1-Hamming-distance correction.

    Barcodes are 2-bit encoded into ints (16bp -> 32 bits) so membership
    and the 3*bc_len variant probes are set lookups on ints.
    """

    def __init__(self, barcodes, bc_len: int):
        self.bc_len = bc_len
        self.exact: set[int] = set()
        for bc in barcodes:
            if len(bc) != bc_len:
                raise ValueError(
                    f"whitelist barcode {bc!r} is not {bc_len}bp"
                )
            enc = _encode_bc(bc.encode() if isinstance(bc, str) else bc)
            if enc is None or enc[1] >= 0:
                raise ValueError(f"whitelist barcode {bc!r} has non-ACGT bases")
            self.exact.add(enc[0])

    @classmethod
    def load(cls, path: str, bc_len: int = 16) -> "Whitelist":
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rt") as f:
            bcs = [line.strip() for line in f if line.strip()]
        return cls(bcs, bc_len)

    _INVALID = np.uint64(0xFFFFFFFFFFFFFFFF)

    def _neighbor_tables(self):
        """Lazy sorted 1-Hamming neighbor table of the whitelist: 3L*W
        packed codes + the member index each came from.  One sorted join
        replaces per-barcode 3L set probes on the batched count path
        (same construction as CellCounts._fold_targets; ~430MB retained
        for the 737k-barcode 10x v3 list — 283MB uint64 codes + 142MB
        int32 member indexes — built once per Whitelist)."""
        t = getattr(self, "_nbr", None)
        if t is None:
            L = self.bc_len
            w = np.fromiter(self.exact, np.uint64, len(self.exact))
            W = len(w)
            nbr = np.empty(3 * L * W, np.uint64)
            k = 0
            for p in range(L):
                sh = np.uint64(2 * (L - 1 - p))
                for d in (1, 2, 3):
                    nbr[k: k + W] = w ^ (np.uint64(d) << sh)
                    k += W
            w_idx = np.tile(np.arange(W, dtype=np.int32), 3 * L)
            order = np.argsort(nbr, kind="stable")
            t = self._nbr = (nbr[order], w_idx[order], w)
        return t

    def correct_clean_batch(self, codes: np.ndarray) -> np.ndarray:
        """Batched 1-Hamming correction for CLEAN (all-ACGT), packed,
        NON-member barcodes: returns the unique whitelist member's code
        per row, or _INVALID when none/ambiguous — exactly wl.match's
        distinct-candidate rule (each (member, position) pair meets a
        query at most once, so the join count IS the candidate count).

        Rent-or-buy: the neighbor table costs ~19s to build at the 737k
        10x-v3 scale but answers in ~3ms/batch (vs ~30us/row probing);
        per-row probes serve until the cumulative row count reaches the
        ~breakeven (≈ |whitelist| rows), so short runs never pay the
        build and long runs converge to the fast path."""
        codes = np.asarray(codes, np.uint64)
        out = np.full(len(codes), self._INVALID, np.uint64)
        if not len(self.exact) or not len(codes):
            return out
        if getattr(self, "_nbr", None) is None:
            seen = getattr(self, "_cb_rows", 0) + len(codes)
            self._cb_rows = seen
            if seen <= max(50_000, len(self.exact)):
                for j, c in enumerate(codes):
                    m = self.match(_decode_2bit(int(c), self.bc_len).encode())
                    if m is not None:
                        out[j] = _encode_bc(m.encode())[0]
                return out
        nbr, w_idx, w = self._neighbor_tables()
        lo = np.searchsorted(nbr, codes, "left")
        hi = np.searchsorted(nbr, codes, "right")
        one = (hi - lo) == 1
        out[one] = w[w_idx[lo[one]]]
        return out

    def match(self, seq: bytes) -> str | None:
        """Exact match or unique 1-Hamming correction; None = drop."""
        enc = _encode_bc(seq)
        if enc is None:
            return None
        code, n_pos = enc
        if n_pos < 0 and code in self.exact:
            return seq.decode()  # clean ACGT input — no rebuild needed
        hit = None
        positions = (n_pos,) if n_pos >= 0 else range(self.bc_len)
        for i in positions:
            shift = 2 * (self.bc_len - 1 - i)
            base = (code >> shift) & 3
            for alt in range(4):
                if alt == base and n_pos < 0:
                    continue
                cand = (code & ~(3 << shift)) | (alt << shift)
                if cand in self.exact:
                    if hit is not None and hit != cand:
                        return None  # ambiguous correction
                    hit = cand
        return self._decode(hit) if hit is not None else None

    def _decode(self, code: int) -> str:
        return _decode_2bit(code, self.bc_len)


@dataclass
class Chemistry:
    bc_len: int = 16
    umi_len: int = 12  # 10x v3; v2 uses 10

    @property
    def r1_min_len(self) -> int:
        return self.bc_len + self.umi_len


def _int_neighbors(x: int, L: int):
    """All 3L packed-int 1-Hamming variants of a 2-bit packed L-mer."""
    for j in range(2 * L - 2, -2, -2):
        base = (x >> j) & 3
        for alt in range(4):
            if alt != base:
                yield (x & ~(3 << j)) | (alt << j)


def _str_neighbors(x: str, _L):
    """All ACGT 1-Hamming substitutions of a string UMI (fallback domain:
    non-ACGT or ragged pools; a non-ACGT char can be REPLACED by an ACGT
    base but never produced, matching the packed domain's reachability)."""
    for i in range(len(x)):
        for b in "ACGT":
            if b != x[i]:
                yield x[:i] + b + x[i + 1:]


def _directional_clusters(counts_map: dict, L: int | None) -> int:
    """The single directional-clustering core (UMI-tools, Smith et al.
    2017): greedy seeds in (-count, token) order; BFS absorb along
    downward edges (hamming==1 and count(u) >= 2*count(v)-1); returns the
    cluster (= molecule) count.  `L` is the UMI length for packed-int
    pools; None selects the string domain."""
    neighbors = _str_neighbors if L is None else _int_neighbors
    order = sorted(counts_map, key=lambda u: (-counts_map[u], u))
    owner: set = set()
    n_clusters = 0
    for seed in order:
        if seed in owner:
            continue
        n_clusters += 1
        stack = [seed]
        owner.add(seed)
        while stack:
            x = stack.pop()
            cx = counts_map[x]
            for v in neighbors(x, L):
                cv = counts_map.get(v)
                if cv is None or v in owner:
                    continue
                if cx >= 2 * cv - 1:
                    owner.add(v)
                    stack.append(v)
    return n_clusters


@dataclass
class CellCounts:
    """Per-cell, per-EC distinct-UMI accumulation.

    Storage is columnar: mapped reads append (cell, class, umi-token)
    rows into chunked int64 arrays, merged lazily (one lexsort +
    segment-sum) into unique triples with read counts.  Molecule
    counting can use exact distinct UMIs or directional clustering
    (Smith et al. 2017 / UMI-tools: u absorbs v when hamming(u,v)==1
    and count(u) >= 2*count(v)-1; molecules = clusters) — per-pool
    dicts are materialized only for multi-UMI directional pools.
    Tokens: big-endian packed 2-bit ints (>= 0) for pure-ACGT UMIs
    that fit int64, else side-interned strings (ids < -1)."""

    classes: dict[tuple[int, ...], int] = field(default_factory=dict)
    cells: dict[str, int] = field(default_factory=dict)
    n_reads: int = 0
    n_mapped: int = 0
    n_bad_r1: int = 0
    n_corrected: int = 0
    n_bad_barcode: int = 0
    umi_len: int | None = None  # needed to probe int-token neighborhoods
    # columnar triple store: unmerged (cell, cls, umi, cnt) chunks plus
    # a scalar staging buffer for the record-path add().  compare=False:
    # ndarray-holding fields would make dataclass == raise / depend on
    # chunk boundaries; identity of a store is its merged content.
    _chunks: list = field(default_factory=list, repr=False, compare=False)
    _row_buf: list = field(default_factory=list, repr=False, compare=False)
    _side_strs: list = field(default_factory=list, repr=False,
                             compare=False)
    _side_ids: dict = field(default_factory=dict, repr=False,
                            compare=False)
    # monotonic mutation counter: every accumulation/fold bumps it, and
    # the _merged/entry_counts memos key on it (n_mapped alone misses
    # direct add_bulk callers)
    _version: int = field(default=0, repr=False, compare=False)

    def _class_id(self, eq: tuple[int, ...]) -> int:
        idx = self.classes.get(eq)
        if idx is None:
            idx = len(self.classes)
            self.classes[eq] = idx
        return idx

    def _cell_id(self, bc: str) -> int:
        idx = self.cells.get(bc)
        if idx is None:
            idx = len(self.cells)
            self.cells[bc] = idx
        return idx

    def _side_tok(self, s: str) -> int:
        """Intern a string-form UMI token -> side id (< -1)."""
        t = self._side_ids.get(s)
        if t is None:
            t = -2 - len(self._side_strs)
            self._side_ids[s] = t
            self._side_strs.append(s)
        return t

    def _pool_tok(self, t: int):
        """Stored token -> pool-dict token (packed int or string)."""
        return t if t >= 0 else self._side_strs[-2 - t]

    def add(self, bc: str, umi: str, eq_class):
        self.n_reads += 1
        if not len(eq_class):
            return
        self.n_mapped += 1
        self._version += 1
        if self.umi_len is None:
            self.umi_len = len(umi)
        tok = _umi_token(umi) if len(umi) == self.umi_len else umi
        if isinstance(tok, str):
            tok = self._side_tok(tok)
        elif tok > 0x3FFFFFFFFFFFFFFF:  # >31-base UMI: packed int would
            tok = self._side_tok(umi)   # overflow int64 — store the string
        self._row_buf.append((
            self._cell_id(bc),
            self._class_id(tuple(int(x) for x in eq_class)),
            tok,
        ))

    def add_bulk(self, cell_ids, class_ids, umi_toks, counts=None):
        """Append mapped rows in bulk (the batched count path).  Tokens
        must already be packed ints >= 0 or side ids from _side_tok."""
        import numpy as np

        n = len(cell_ids)
        if not n:
            return
        cnt = (np.ones(n, np.int64) if counts is None
               else np.asarray(counts, np.int64))
        self._version += 1
        self._chunks.append((
            np.asarray(cell_ids, np.int64), np.asarray(class_ids, np.int64),
            np.asarray(umi_toks, np.int64), cnt,
        ))

    def _merged(self):
        """Canonical triple store: unique (cell, cls, umi) rows with
        summed read counts, lexsorted by (cell, cls, umi).  Incremental:
        the previous merge rides as one input chunk."""
        import numpy as np

        if self._row_buf:
            rows = np.asarray(self._row_buf, np.int64).reshape(-1, 3)
            self._row_buf.clear()
            self._chunks.append(
                (rows[:, 0], rows[:, 1], rows[:, 2],
                 np.ones(len(rows), np.int64))
            )
        cache = getattr(self, "_merged_cache", None)
        if cache is not None and not self._chunks:
            return cache
        if cache is not None:
            self._chunks.insert(0, cache)
        if not self._chunks:
            z = np.zeros(0, np.int64)
            self._merged_cache = (z, z, z, z)
            return self._merged_cache
        ce = np.concatenate([c[0] for c in self._chunks])
        cl = np.concatenate([c[1] for c in self._chunks])
        um = np.concatenate([c[2] for c in self._chunks])
        ct = np.concatenate([c[3] for c in self._chunks])
        self._chunks.clear()
        # single packed-int64 key when the (cell, cls, umi) ranges fit 63
        # bits (cell in the high bits -> int64 order == lexsort order);
        # one argsort is ~2x the three-key lexsort at the merge sizes
        order = None
        if len(ce):
            lo_u = um.min()
            spans = (int(ce.max()) + 1, int(cl.max()) + 1,
                     int(um.max()) - int(lo_u) + 1)
            bits = [max(1, (s - 1).bit_length()) for s in spans]
            if sum(bits) <= 63:
                key = ((ce << (bits[1] + bits[2]))
                       | (cl << bits[2]) | (um - lo_u))
                order = np.argsort(key)
        if order is None:
            order = np.lexsort((um, cl, ce))
        ce, cl, um, ct = ce[order], cl[order], um[order], ct[order]
        new = np.empty(len(ce), bool)
        new[0] = True
        new[1:] = ((ce[1:] != ce[:-1]) | (cl[1:] != cl[:-1])
                   | (um[1:] != um[:-1]))
        idx = np.nonzero(new)[0]
        ct = np.add.reduceat(ct, idx)
        self._merged_cache = (ce[idx], cl[idx], um[idx], ct)
        return self._merged_cache

    @property
    def umis(self) -> dict:
        """Materialized dict-of-dicts view {(cell, cls): {token: count}}
        (debug/compat; the hot paths stay columnar)."""
        ce, cl, um, ct = self._merged()
        out: dict[tuple[int, int], dict] = {}
        for c, k, t, n in zip(ce.tolist(), cl.tolist(), um.tolist(),
                              ct.tolist()):
            out.setdefault((c, k), {})[self._pool_tok(t)] = n
        return out

    def molecule_count(self, umi_counts: dict, method: str = "exact") -> int:
        """Molecules in one (cell, class) UMI pool.

        exact: distinct UMIs.  directional: UMI-tools clustering — an edge
        u->v when hamming(u,v)==1 and count(u) >= 2*count(v)-1; each
        cluster (seeded greedily from the highest-count UMI) is one
        molecule.  ONE clustering core (`_directional_clusters`) serves
        every token form; this method only normalizes the pool's keys to
        the core's int (packed 2-bit) or string domain."""
        if method == "exact":
            return len(umi_counts)
        if method != "directional":
            raise ValueError(f"unknown UMI dedup method {method!r}")
        if len(umi_counts) == 1:
            return 1
        has_str = any(isinstance(u, str) for u in umi_counts)
        has_int = any(not isinstance(u, str) for u in umi_counts)
        if has_str and has_int:
            # mixed pool (rare: N-containing UMIs beside clean ones):
            # decode int tokens — tokens can't collide (a pure-ACGT
            # uppercase UMI always packs, so no equal str token exists)
            umi_counts = {
                (u if isinstance(u, str) else _decode_2bit(u, self.umi_len)):
                    c
                for u, c in umi_counts.items()
            }
            has_int = False
        if has_int:
            if self.umi_len is None:
                raise ValueError(
                    "int-token UMI pool requires CellCounts.umi_len"
                )
            return _directional_clusters(umi_counts, self.umi_len)
        # all-string pool: pack fixed-length pure-ACGT keys to ints (a
        # neighbor probe is one XOR instead of string splicing; for
        # fixed-length uppercase ACGT, string order == packed-int order,
        # so the greedy seed order is unchanged), else run the core in
        # its string domain (non-ACGT or ragged UMIs)
        first = next(iter(umi_counts))
        L = len(first)
        packed: dict[str, int] | None = {}
        for u in umi_counts:
            if len(u) != L:
                packed = None
                break
            code = 0
            for ch in u:
                v = _BASE_CODE.get(ord(ch))
                if v is None:
                    packed = None
                    break
                code = (code << 2) | v
            if packed is None:
                break
            packed[u] = code
        if packed is not None:
            return _directional_clusters(
                {packed[u]: c for u, c in umi_counts.items()}, L
            )
        return _directional_clusters(umi_counts, None)

    def _entry_arrays(self, method: str = "exact"):
        """Columnar molecule counts: (cells, classes, molecules) int64
        arrays over unique (cell, class) pools, lexsorted by (cell,
        class); computed once per (method, version) and memoized —
        directional clustering dominates the cost and write(),
        cell_totals() and call_cells() all need it.

        exact counts come straight off the columnar store (pool size =
        segment length over unique triples); directional materializes a
        dict only for multi-UMI pools that survive the 1-Hamming
        collision screen."""
        cache = getattr(self, "_entry_arrays_cache", None)
        key = (method, self._version)
        if cache is not None and cache[0] == key:
            return cache[1]
        import numpy as np

        ce, cl, um, ct = self._merged()
        z = np.zeros(0, np.int64)
        out = (z, z, z)
        if len(ce):
            new = np.empty(len(ce), bool)
            new[0] = True
            new[1:] = (ce[1:] != ce[:-1]) | (cl[1:] != cl[:-1])
            gidx = np.nonzero(new)[0]
            sizes = np.diff(np.append(gidx, len(ce)))
            mols = sizes.astype(np.int64)
            if method == "exact":
                pass  # pool size IS the molecule count
            elif method == "directional":
                # vectorized 1-Hamming screen: two packed UMIs are
                # Hamming-1 iff they share a (position, token-with-that-
                # position-masked) key, so pools whose rows produce no
                # duplicate masked key need no clustering (count = pool
                # size) — for random 12-mers that is almost every pool.
                # Pools WITH collisions (or side-interned string tokens)
                # take the exact per-pool BFS (molecule_count).
                need = np.zeros(len(gidx), bool)
                multi = sizes >= 2
                if multi.any() and self.umi_len is not None:
                    grp = np.repeat(np.arange(len(gidx)), sizes)
                    rows = np.nonzero(multi[grp])[0]
                    g_r, u_r = grp[rows], um[rows]
                    side_r = u_r < 0
                    if side_r.any():
                        need |= np.bincount(
                            g_r[side_r], minlength=len(gidx)
                        ).astype(bool)
                        keep = ~side_r
                        g_r, u_r = g_r[keep], u_r[keep]
                    L_ = self.umi_len
                    gbits = 63 - 2 * L_
                    if (len(g_r) and 2 * L_ <= 62
                            and len(gidx) < (1 << max(gbits, 1))):
                        # one packed (pool << 2L | masked-umi) key per
                        # position: a scalar mask + int64 sort per pass
                        # beats one 3-key lexsort over the Lx-expanded
                        # arrays ~4x (no tile/repeat materialization)
                        shift = np.int64(2 * L_)
                        base_key = g_r.astype(np.int64) << shift
                        for p_ in range(L_):
                            mask = np.int64(~(3 << (2 * p_)))
                            ks = np.sort(base_key | (u_r & mask))
                            dupk = ks[1:] == ks[:-1]
                            if dupk.any():
                                d2 = np.zeros(len(ks), bool)
                                d2[1:] = dupk
                                d2[:-1] |= dupk
                                need[ks[d2] >> shift] = True
                    elif len(g_r):
                        need |= np.bincount(
                            g_r, minlength=len(gidx)
                        ).astype(bool)
                elif multi.any():
                    need = multi.copy()
                for j in np.nonzero(need & multi)[0]:
                    st, s = int(gidx[j]), int(sizes[j])
                    pool = {
                        self._pool_tok(int(t)): int(n)
                        for t, n in zip(um[st:st + s], ct[st:st + s])
                    }
                    mols[j] = self.molecule_count(pool, method)
            else:
                raise ValueError(f"unknown UMI dedup method {method!r}")
            out = (ce[gidx], cl[gidx], mols)
        self._entry_arrays_cache = (key, out)
        return out

    def entry_counts(self, method: str = "exact") -> dict:
        """Molecule count per (cell, class) pool as a dict (write() and
        compat; the hot aggregations use `_entry_arrays` directly)."""
        gc, gk, mols = self._entry_arrays(method)
        return dict(zip(zip(gc.tolist(), gk.tolist()), mols.tolist()))

    def cell_totals(self, method: str = "exact") -> dict[int, int]:
        """Per-cell total molecule counts (one segment-sum over the
        columnar pools — cells arrive lexsorted from _entry_arrays)."""
        import numpy as np

        gc, _gk, mols = self._entry_arrays(method)
        if not len(gc):
            return {}
        tot = np.bincount(gc, weights=mols, minlength=len(self.cells))
        nz = np.nonzero(tot)[0]
        return dict(zip(nz.tolist(), tot[nz].astype(np.int64).tolist()))

    def call_cells(self, method: str = "exact") -> list[str]:
        """Knee-point cell calling (whitelist-free): cells ranked by total
        molecules; the knee is the point of maximum distance to the chord
        of the log-log rank curve.  Returns called barcodes in rank order.
        """
        import numpy as np

        totals = self.cell_totals(method)
        if not totals:
            return []
        inv_cells = {v: k for k, v in self.cells.items()}
        ranked = sorted(totals.items(), key=lambda kv: (-kv[1], kv[0]))
        y = np.log10(np.array([t for _, t in ranked], dtype=np.float64))
        if len(y) < 3 or y[0] == y[-1]:
            return [inv_cells[c] for c, _ in ranked]
        x = np.log10(np.arange(1, len(y) + 1, dtype=np.float64))
        # distance from each point to the first-last chord
        dx, dy = x[-1] - x[0], y[-1] - y[0]
        dist = np.abs(dy * (x - x[0]) - dx * (y - y[0]))
        knee = int(np.argmax(dist))
        return [inv_cells[c] for c, _ in ranked[: knee + 1]]

    def _fold_targets(self, wl: "Whitelist", called_set: set):
        """Vectorized whitelist fold resolution (VERDICT r3 #7): yields
        (cid, called_code) for every uncalled barcode with a UNIQUE
        1-Hamming called neighbor — semantics of `wl.match` per barcode
        (ambiguous >=2 candidates drop; single-N barcodes try all 4
        bases at the N position), but as L masked-key sorted joins
        instead of ~1M * 3L python set probes (seconds, not minutes, at
        real 10x scale).

        Masked-key rule: u and w are 1-Hamming iff their codes agree
        with position p masked out, for exactly one p — and an uncalled
        clean u can never equal a called w, so every masked-join hit IS
        a distinct candidate; candidate count per u == wl.match's
        distinct-hit count."""
        import numpy as np

        L = wl.bc_len
        names = []
        cids = []
        for bc, cid in self.cells.items():
            if bc not in called_set and len(bc) == L:
                names.append(bc)
                cids.append(cid)
        if not names:
            return
        joined = "".join(names).encode("utf-8", "surrogateescape")
        if len(joined) != L * len(names):
            # non-ASCII barcode strings (garbage reads): per-barcode
            # fallback, exact original semantics
            for bc, cid in zip(names, cids):
                m = wl.match(bc.encode("utf-8", "surrogateescape"))
                if m is not None and m != bc:
                    enc = _encode_bc(m.encode())
                    yield cid, enc[0]
            return
        raw = np.frombuffer(joined, np.uint8).reshape(len(names), L)
        lut = np.full(256, 255, np.uint8)
        for i, b in enumerate(b"ACGT"):
            lut[b] = i
        codes2 = lut[raw]
        bad = codes2 == 255
        nbad = bad.sum(axis=1)
        keep = nbad <= 1  # >1 non-ACGT never folds (_encode_bc -> None)
        if not keep.any():
            return
        codes2 = np.where(bad, 0, codes2)[keep]
        # big-endian 2-bit pack (matches _encode_bc): column
        # shift-accumulate (a uint64 matmul has no BLAS path — 10x slower)
        u_code = np.zeros(len(codes2), np.uint64)
        for i in range(L):
            u_code |= codes2[:, i].astype(np.uint64) << np.uint64(
                2 * (L - 1 - i)
            )
        u_np = np.where(nbad[keep] == 1, np.argmax(bad[keep], axis=1),
                        -1).astype(np.int64)
        u_cid = np.asarray(cids, np.int64)[keep]
        w_code = np.fromiter(wl.exact, np.uint64, len(wl.exact))
        W = len(w_code)

        n_hits = np.zeros(len(u_cid), np.int64)
        hit_w = np.zeros(len(u_cid), np.uint64)

        # clean barcodes: ONE sorted join of u_code against the 3L*W
        # 1-Hamming neighbor table of the called set (u == neighbor(w)
        # <=> u is 1-Hamming from w; an uncalled clean u never equals a
        # called w, and each (u, w) pair meets at exactly one neighbor,
        # so the match count IS wl.match's distinct-candidate count)
        clean = np.nonzero(u_np < 0)[0]
        if len(clean) and W:
            # shared construction with the batched count path (review
            # r5: this loop duplicated Whitelist._neighbor_tables token
            # for token).  `wl` is the per-call called-set whitelist, so
            # the cached table dies with it — no long-lived retention.
            nbr, nbr_w, w_tab = wl._neighbor_tables()
            assert len(w_tab) == W
            uk = u_code[clean]
            lo = np.searchsorted(nbr, uk, "left")
            hi = np.searchsorted(nbr, uk, "right")
            n = hi - lo
            got = n >= 1
            n_hits[clean] += n
            hit_w[clean[got]] = w_code[nbr_w[lo[got]]]

        # single-N barcodes (rare): all 4 bases at the N position are
        # candidates — masked-key join at that one position
        npos_rows = np.nonzero(u_np >= 0)[0]
        if len(npos_rows) and W:
            for p in np.unique(u_np[npos_rows]):
                mask = np.uint64(
                    ~(3 << (2 * (L - 1 - int(p)))) & ((1 << (2 * L)) - 1)
                )
                order = np.argsort(w_code & mask, kind="stable")
                wk = (w_code & mask)[order]
                rows = npos_rows[u_np[npos_rows] == p]
                uk = u_code[rows] & mask
                lo = np.searchsorted(wk, uk, "left")
                hi = np.searchsorted(wk, uk, "right")
                n = hi - lo
                got = n >= 1
                n_hits[rows] += n
                hit_w[rows[got]] = w_code[order[lo[got]]]

        unique = n_hits == 1
        for cid, w in zip(u_cid[unique].tolist(), hit_w[unique].tolist()):
            yield cid, w

    def correct_barcodes(self, method: str = "exact") -> int:
        """Whitelist-free barcode error correction (alevin convention):
        knee-call abundant barcodes (`call_cells`), then fold each
        uncalled barcode's molecules into the unique called barcode at
        Hamming distance 1.  Ambiguous (>=2 called candidates) or
        distant barcodes keep their own cell.  Folded UMI pools merge
        (same molecule, misread barcode).  Returns the number of
        barcodes folded; `n_corrected` advances by the same amount."""
        import numpy as np

        called = self.call_cells(method)
        ce, cl, um, ct = self._merged()
        if not called or len(called) == len(self.cells) or not len(ce):
            return 0
        # face-value accumulation can intern N-containing barcodes; they
        # can still FOLD (single-N match) but cannot be fold TARGETS
        acgt = set("ACGT")
        wl_bcs = [b for b in called if set(b) <= acgt]
        if not wl_bcs:
            return 0
        wl = Whitelist(wl_bcs, len(wl_bcs[0]))
        called_set = set(called)
        inv = {v: k for k, v in self.cells.items()}
        target = np.arange(len(self.cells), dtype=np.int64)
        folded = 0
        for cid, w_code in self._fold_targets(wl, called_set):
            m = wl._decode(int(w_code))
            target[cid] = self.cells[m]
            folded += 1
        if not folded:
            return 0
        new_cells: dict[str, int] = {}
        renum = np.full(len(target), -1, np.int64)
        for cid in range(len(target)):  # keep first-appearance order
            if target[cid] == cid:
                renum[cid] = len(new_cells)
                new_cells[inv[cid]] = int(renum[cid])
        # relabel the columnar store in one take; folded pools merge
        # (duplicate triples sum) at the next lazy merge
        self.cells = new_cells
        self._merged_cache = None
        self._chunks = [(renum[target][ce], cl, um, ct)]
        self._version += 1
        self.n_corrected += folded
        self._entry_arrays_cache = None
        return folded

    def write(self, outdir: str, umi_dedup: str = "exact") -> None:
        os.makedirs(outdir, exist_ok=True)
        inv_cells = {v: k for k, v in self.cells.items()}
        with open(os.path.join(outdir, "barcodes.tsv"), "w") as f:
            for i in range(len(self.cells)):
                f.write(inv_cells[i] + "\n")
        inv_classes = {v: k for k, v in self.classes.items()}
        with open(os.path.join(outdir, "ec.tsv"), "w") as f:
            for i in range(len(self.classes)):
                f.write(f"{i}\t{','.join(map(str, inv_classes[i]))}\n")
        entries = sorted(
            (cell, cls, n)
            for (cell, cls), n in self.entry_counts(umi_dedup).items()
        )
        with open(os.path.join(outdir, "matrix.mtx"), "w") as f:
            f.write("%%MatrixMarket matrix coordinate integer general\n")
            f.write(f"%\n{len(self.cells)} {len(self.classes)} {len(entries)}\n")
            for cell, cls, n in entries:
                f.write(f"{cell + 1} {cls + 1} {n}\n")


def count_single_cell(
    aligner: Pseudoaligner,
    r1_path: str,
    r2_path: str,
    chem: Chemistry | None = None,
    whitelist: Whitelist | None = None,
    bc_correct: bool = True,
    umi_dedup: str = "exact",
) -> CellCounts:
    """Run the 10x counting pipeline.  R1: barcode+UMI; R2: cDNA.

    With a whitelist, barcodes are corrected/filtered per the module
    docstring; corrected reads count toward their corrected cell.
    Without one (and `bc_correct`), knee-called abundant barcodes absorb
    their unique 1-Hamming neighbors post-accumulation
    (CellCounts.correct_barcodes; `umi_dedup` picks the molecule-count
    method behind the knee).

    Uses the batched fast path when the aligner serves compact outputs
    (the default): R2 maps through the same depth-1 pipeline as `map`,
    per-read EC lists are never materialized (class identity comes from
    the device's distinct-class signatures, interned in first-appearance
    read order — same ec.tsv/matrix ordering as the record path), and
    barcodes resolve through the whitelist per read (exact set hit or
    unique 1-Hamming correction).
    """
    chem = chem or Chemistry()
    if aligner.meta.distinct_cap > 0:
        counts = _count_batched(aligner, r1_path, r2_path, chem, whitelist)
    else:
        counts = _count_records(aligner, r1_path, r2_path, chem, whitelist)
    if whitelist is None and bc_correct:
        counts.correct_barcodes(umi_dedup)
    return counts


def _process_r1(counts, seq1: bytes, chem: Chemistry, whitelist):
    """R1 barcode handling for one read -> cell key or None (counted)."""
    if len(seq1) < chem.r1_min_len:
        counts.n_bad_r1 += 1
        counts.n_reads += 1
        return None, None
    raw_bc = seq1[: chem.bc_len]
    if whitelist is not None:
        bc = whitelist.match(raw_bc)
        if bc is None:
            counts.n_bad_barcode += 1
            counts.n_reads += 1
            return None, None
        if bc != raw_bc.decode():
            counts.n_corrected += 1
    else:
        bc = raw_bc.decode()
    umi = seq1[chem.bc_len : chem.bc_len + chem.umi_len].decode()
    return bc, umi


def _count_records(aligner, r1_path, r2_path, chem, whitelist) -> CellCounts:
    """Per-read record path (full-output configs)."""
    counts = CellCounts(umi_len=chem.umi_len)
    r1 = read_fastq_records(r1_path)
    from .io.fastq import FastqReader

    r2 = FastqReader(
        r2_path, aligner.config.batch_size, aligner.config.max_read_len
    )
    try:
        for batch in r2:
            res = aligner.records_from_result(
                aligner.map_batch_device(batch.codes, batch.lens), batch)
            for rec in res:
                try:
                    _, seq1 = next(r1)
                except StopIteration:
                    raise ValueError("R1 has fewer reads than R2")
                bc, umi = _process_r1(counts, seq1, chem, whitelist)
                if bc is None:
                    continue
                counts.add(bc, umi, rec.eq_class if rec.coverage else ())
    finally:
        # release handles deterministically on mid-stream errors too
        # (the batched path already does — review r5)
        r2.close()
        r1.close()
    return counts


def _count_batched(aligner, r1_path, r2_path, chem, whitelist) -> CellCounts:
    """Batched counting over compact signatures (the serving fast path).

    R1 streams as fixed-width RAW prefix rows through one native scan per
    batch (io/fastq.R1PrefixReader: N/case preserved, too-short rows are
    0xFF), and the per-batch accumulation is vectorized: barcode/UMI pack
    to ints, class/cell interning runs over unique keys in
    first-appearance READ order (exact ordering parity with the record
    path), and UMI counts accumulate per unique (cell, class, umi) triple
    instead of per read.  Rows the vector path can't represent (whitelist
    corrections, non-ACGT barcodes/UMIs) resolve in a small per-row loop."""
    counts = CellCounts(umi_len=chem.umi_len)
    from .io.fastq import FastqReader, R1PrefixReader

    ml = chem.r1_min_len
    bl = chem.bc_len
    ul = ml - bl
    r1 = R1PrefixReader(r1_path, ml)
    r2 = FastqReader(
        r2_path, aligner.config.batch_size, aligner.config.max_read_len
    )

    import numpy as np

    bc_lut = np.full(256, 255, np.uint8)
    for _j, _b in enumerate(b"ACGT"):
        bc_lut[_b] = _j
    # int keys: packed 2-bit strings (>= 0) or side-interned odd strings
    # (< -1; -1 = invalid row).  Packing needs 2*len bits in an int64.
    packable = 2 * bl <= 62 and 2 * ul <= 62
    wl_sorted = None
    if whitelist is not None and packable:
        # only the packable vector path consumes this; bc_len >= 33
        # codes overflow uint64 and ride the per-row loop instead
        # (np.fromiter would raise OverflowError — review r5)
        wl_sorted = np.sort(
            np.fromiter(whitelist.exact, np.uint64, len(whitelist.exact))
        )
    side_keys: dict[bytes, int] = {}
    side_strs: list[str] = []

    def _side_key(raw: bytes) -> int:
        k = side_keys.get(raw)
        if k is None:
            k = -2 - len(side_strs)
            side_keys[raw] = k
            side_strs.append(raw.decode())
        return k

    cell_of_key: dict[int, int] = {}
    # class id per distinct signature CONTENT, keyed on the raw int64
    # bytes of the EC list — one dict probe for re-seen content instead
    # of a tuple materialization (tolist + tuple) per unique token
    cls_by_bytes: dict[bytes, int] = {}

    # fused C++ key derivation (VERDICT r4 #3: the count row is
    # host-core bound): one native pass replaces the LUT gather +
    # per-column shift packs + whitelist searchsorted (~37ms/65k batch
    # of numpy work).  The numpy block below stays as the no-toolchain
    # fallback and the differential-fuzz oracle
    # (tests/test_workloads.py::test_count_native_keys_parity).
    _nat = None
    if packable and os.environ.get("PA_NATIVE_COUNTKEYS", "1") != "0":
        try:
            from .io import native as _nat_mod

            _nat_mod._load()
            _nat = _nat_mod
        except Exception:
            _nat = None

    def consume(state, arr):
        overflow = aligner._remap_collect(state["remap_fut"])
        inv = np.asarray(state["inv"], dtype=np.int64)
        none_mask = state["none_mask"]
        sig_start = state["sig_start"]
        sig_flat = state["sig_flat"]
        n = state["n"]
        arr = arr[:n]
        if _nat is not None:
            bckey, ukey, status, pk_bc, pk_umi, n_short = _nat.count_r1keys(
                arr, bl, wl_sorted)
            short = status == 1
            clean = status <= 2  # 0 exact | 2 clean non-member
            clean &= ~short
            exact = status == 0
            counts.n_reads += n
            counts.n_bad_r1 += n_short
        else:
            short = arr[:, 0] == 0xFF
            counts.n_reads += n
            counts.n_bad_r1 += int(short.sum())

            codes = bc_lut[arr]
            clean = ~short & (codes != 255).all(axis=1)
            pk_bc = np.zeros(n, np.uint64)
            for j in range(bl):
                pk_bc = (pk_bc << np.uint64(2)) | codes[:, j].astype(np.uint64)
            pk_umi = np.zeros(n, np.uint64)
            for j in range(bl, ml):
                pk_umi = (pk_umi << np.uint64(2)) | codes[:, j].astype(np.uint64)

            if wl_sorted is not None:
                if len(wl_sorted):
                    pos = np.minimum(
                        np.searchsorted(wl_sorted, pk_bc), len(wl_sorted) - 1
                    )
                    exact = clean & (wl_sorted[pos] == pk_bc)
                else:
                    exact = np.zeros(n, bool)
            else:
                exact = clean
            if not packable:
                exact = np.zeros(n, bool)  # everything through the row loop

            bckey = np.where(exact, pk_bc.astype(np.int64), np.int64(-1))
            ukey = np.where(exact, pk_umi.astype(np.int64), np.int64(-1))

        # clean-but-not-exact rows correct through the whitelist's
        # batched neighbor-table join (the per-row wl.match loop cost
        # ~15us/row — material at realistic error rates); rows with
        # non-ACGT bases keep the per-row path below
        done = np.zeros(n, bool)
        if whitelist is not None and packable:
            vrows_ = np.nonzero(~short & ~exact & clean)[0]
            if len(vrows_):
                corr = whitelist.correct_clean_batch(pk_bc[vrows_])
                ok = corr != Whitelist._INVALID
                counts.n_bad_barcode += int((~ok).sum())
                # a clean non-member's unique correction always differs
                # from the raw barcode -> every hit counts as corrected
                counts.n_corrected += int(ok.sum())
                okr = vrows_[ok]
                bckey[okr] = corr[ok].astype(np.int64)
                ukey[okr] = pk_umi[okr].astype(np.int64)
                done[vrows_] = True

        # rows the vector path can't represent: non-ACGT barcodes/UMIs,
        # unpackable chemistry (and, without a whitelist, face value)
        for i in np.nonzero(~short & ~exact & ~done)[0]:
            raw = arr[i].tobytes()
            raw_bc = raw[:bl]
            if whitelist is not None:
                bc = whitelist.match(raw_bc)
                if bc is None:
                    counts.n_bad_barcode += 1
                    continue
                if bc != raw_bc.decode():
                    counts.n_corrected += 1
                bcb = bc.encode()
            else:
                bcb = raw_bc
            bcodes = bc_lut[np.frombuffer(bcb, np.uint8)]
            if packable and (bcodes != 255).all():
                k = 0
                for c in bcodes:
                    k = (k << 2) | int(c)
                bckey[i] = k
            else:
                bckey[i] = _side_key(bcb)
            ucodes = bc_lut[arr[i, bl:ml]]
            if packable and (ucodes != 255).all():
                ukey[i] = int(pk_umi[i])
            else:
                ukey[i] = _side_key(raw[bl:ml])

        valid = np.zeros(n, bool)
        valid[~short] = True
        if whitelist is not None or not packable:
            valid &= bckey != -1  # dropped barcodes

        # class id per row: token = signature id, or a unique per-row
        # token for overflow rows; interned over unique tokens in
        # first-appearance read order (record-path parity — _class_id
        # dedups content across tokens)
        n_sig = len(none_mask)
        tok = inv[:n].copy()
        orows = np.asarray(state["overflow_rows"], np.int64)
        if len(orows):
            tok[orows] = n_sig + orows
        vrows = np.nonzero(valid)[0]
        vtok = tok[vrows]
        # return_inverse: one sort instead of sort + a second
        # searchsorted pass (~5ms/65k batch each — host-bound row)
        uniq_t, first_t, inv_t = np.unique(
            vtok, return_index=True, return_inverse=True)
        sig64 = np.ascontiguousarray(sig_flat, dtype=np.int64)
        cid_of_uniq = np.empty(len(uniq_t), np.int64)
        for u in np.argsort(first_t, kind="stable"):
            t = int(uniq_t[u])
            if t >= n_sig:
                ec = np.ascontiguousarray(overflow[t - n_sig][0],
                                          dtype=np.int64)
            elif none_mask[t]:
                cid_of_uniq[u] = -1
                continue
            else:
                ec = sig64[sig_start[t]:sig_start[t + 1]]
            keyb = ec.tobytes()
            cid = cls_by_bytes.get(keyb)
            if cid is None:
                tup = tuple(ec.tolist())
                cid = counts._class_id(tup) if tup else -1
                cls_by_bytes[keyb] = cid
            cid_of_uniq[u] = cid
        vcid = cid_of_uniq[inv_t]

        mapped = vcid >= 0
        counts.n_mapped += int(mapped.sum())
        mrows = vrows[mapped]
        if not len(mrows):
            return
        mcid = vcid[mapped]
        mbc = bckey[mrows]
        mumi = ukey[mrows]

        # cell interning in first-appearance read order among mapped rows
        uniq_b, first_b, inv_b = np.unique(
            mbc, return_index=True, return_inverse=True)
        # bulk-decode the batch's NEW packed barcodes (the per-key python
        # _decode_2bit loop was ~25us/barcode — prohibitive at the ~1M
        # raw-barcode scale of real 10x runs)
        new_keys = [k for k in uniq_b.tolist()
                    if k >= 0 and k not in cell_of_key]
        dec_new: dict[int, str] = {}
        if new_keys:
            kk = np.asarray(new_keys, np.uint64)
            sh = 2 * (bl - 1 - np.arange(bl, dtype=np.uint64))
            ch = np.frombuffer(b"ACGT", np.uint8)[
                ((kk[:, None] >> sh[None, :]) & np.uint64(3)).astype(np.int64)
            ].tobytes()
            dec_new = {k: ch[j * bl:(j + 1) * bl].decode()
                       for j, k in enumerate(new_keys)}
        cell_of_uniq = np.empty(len(uniq_b), np.int64)
        for u in np.argsort(first_b, kind="stable"):
            key = int(uniq_b[u])
            cell = cell_of_key.get(key)
            if cell is None:
                s = dec_new[key] if key >= 0 else side_strs[-2 - key]
                cell = counts._cell_id(s)
                cell_of_key[key] = cell
            cell_of_uniq[u] = cell
        mcell = cell_of_uniq[inv_b]

        # bulk columnar append: packed keys ARE the canonical umi token;
        # batch-side keys (< -1) translate into counts-side tokens the
        # way the record path does.  Triples merge (lexsort +
        # segment-sum) lazily inside CellCounts — no per-group dict
        # traffic on the streaming path.
        mtok = mumi.copy()
        for i in np.nonzero(mumi < 0)[0]:
            s = side_strs[-2 - int(mumi[i])]
            t = _umi_token(s)
            if isinstance(t, str) or t > 0x3FFFFFFFFFFFFFFF:
                t = counts._side_tok(s)  # odd or >31-base: store the string
            mtok[i] = t
        counts.add_bulk(mcell, mcid, mtok)

    try:
        # depth-D deferral on both device waits (pipeline.py):
        # emit_prepare(k) waits on map(k)'s compact fetch and consume(k)
        # waits on remap(k) — each runs only after pipeline_depth more
        # map steps are queued, so the FIFO tunnel queue stays full
        from .pipeline import DepthPipeline, prefetch_iter

        pipe = DepthPipeline(
            getattr(aligner.config, "pipeline_depth", 1),
            prepare=lambda t, _n: (
                aligner.emit_prepare(t[0], t[1], defer_group=True), t[2]),
            # grouping on the ordered single-worker render pool;
            # accumulation at the ordered FIFO finish (main thread, which
            # otherwise just waits between dispatches) — the two stages
            # pipeline across batches, and both are order-preserving so
            # first-appearance interning is unchanged.  One render stage
            # carrying both measured ~120ms/batch on the chip vs the
            # ~52ms device step: the render thread WAS the critical path
            # (PERF.md round 4, c13).
            finish=lambda t: consume(*t),
            render=lambda st: (aligner.emit_prepare_group(st[0]), st[1]),
        )

        def _src():  # parse R2 + scan R1 a couple of batches ahead
            for batch in r2:
                yield batch, r1.take(batch.n_reads)

        pf = prefetch_iter(_src())
        try:
            for batch, arr in pf:
                fut = aligner.map_batch_device(batch.codes, batch.lens)
                if arr.shape[0] < batch.n_reads:
                    # a short R1 may be a stashed gz corruption error
                    # (deliver-then-error) — attribute it, don't report
                    # a misleading read-count mismatch
                    err = r1.pending_error()
                    if err is not None:
                        raise err
                    raise ValueError("R1 has fewer reads than R2")
                pipe.push((fut, batch, arr))
            pipe.close()
        except BaseException:
            pipe.abort()  # drop queued work; no orphan render tasks
            raise
        finally:
            pf.close()  # stop + join BEFORE the readers close below
    finally:
        # close even on mid-stream errors: R1PrefixReader holds an mmap
        # of the whole R1 file
        r1.close()
        r2.close()
    return counts
