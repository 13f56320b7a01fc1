"""The plain reference's de Bruijn graph, built again from the transcripts.

Written from the reference pseudoaligner's index definition (debruijn
`filter_kmers` + `compress_kmers_with_hash` with `ScmapCompress`, under
MIN_KMERS=1, STRANDED=true), in NumPy, with nothing of the program:

- a k-mer is the integer sum(code[i] << 2(k-1-i)), codes A=0 C=1 G=2 T=3;
- a k-mer's extensions are the bases seen beside it in any transcript
  (bits 0-3 right, 4-7 left), its class the set of transcripts holding it;
- classes are numbered by first appearance in ascending k-mer order;
- k-mer u joins its successor v when u's right extension and v's left
  extension are unique, they point at each other, and the classes are
  equal; a self-loop is no join, and a cycle of joins is cut at the edge
  that enters its least k-mer;
- a node is a maximal chain of joins: its bases, class, extensions (the
  first k-mer's left ones and the last k-mer's right ones) and, per
  extension base, the node it leads to.

A k-mer of k from 1 to 32 is held as one uint64; one of k from 33 to 64
as two words (hi, lo), the value hi * 2**64 + lo, so that the low word
holds the last 32 bases.  Words compare most significant first, which is
the order of the integers.

`RefGraph.build` keeps the arrays a read's walk needs and `save`/`load`
keep them as .npy files (loaded memory-mapped).
"""

from __future__ import annotations

import os

import numpy as np

ARRAYS = ("kmers", "node", "off", "node_ec", "node_exts", "node_len",
          "node_seq_start", "node_seq", "r_edge", "l_edge")
# the build sorts the k-mers of each prefix of up to 2 bases apart, so
# that a sort holds a sixteenth of the occurrences at a time
BUCKET_BASES = 2
NO_BUCKET = 255  # a position where no k-mer starts


def n_words(k: int) -> int:
    """uint64 words a k-mer is held in: one up to k = 32, else two."""
    if not 1 <= k <= 64:
        raise ValueError(f"k={k}: the reference holds k from 1 to 64")
    return 1 if k <= 32 else 2


def _word_bases(k: int) -> list:
    """Bases in each word, most significant first."""
    return [k] if n_words(k) == 1 else [k - 32, 32]


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser, elementwise on uint64."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _kmer_words(bases: np.ndarray, k: int) -> tuple:
    """[..., n] codes -> the word arrays of its k-mers, each
    [..., n - k + 1] uint64, most significant first."""
    n = max(bases.shape[-1] - k + 1, 0)
    words, at = [], 0
    for nb in _word_bases(k):
        v = np.zeros(bases.shape[:-1] + (n,), np.uint64)
        for j in range(at, at + nb):
            v <<= np.uint64(2)
            v |= bases[..., j:j + n]
        words.append(v)
        at += nb
    return tuple(words)


def kmer_values(bases: np.ndarray, k: int) -> np.ndarray:
    """[..., n] codes -> the k-mer values: [..., n - k + 1] uint64 up to
    k = 32, else [..., n - k + 1, 2] words (hi, lo)."""
    ws = _kmer_words(bases, k)
    return ws[0] if len(ws) == 1 else np.stack(ws, axis=-1)


def kmer_int(value) -> int:
    """The integer of one k-mer value as `kmer_values` gives it."""
    out = 0
    for w in np.atleast_1d(value):
        out = (out << 64) | int(w)
    return out


def _columns(values: np.ndarray, k: int) -> tuple:
    """The word arrays of k-mer values as `kmer_values` gives them."""
    if n_words(k) == 1:
        return (values,)
    return tuple(np.ascontiguousarray(values[..., i]) for i in range(2))


def _push_right(ws: tuple, b, k: int) -> tuple:
    """Each k-mer's successor by base b: (u << 2 | b) mod 4**k."""
    nbs = _word_bases(k)
    out = []
    for i, w in enumerate(ws):
        low = ws[i + 1] >> np.uint64(62) if i + 1 < len(ws) else b
        out.append(((w << np.uint64(2)) | low)
                   & np.uint64((1 << 2 * nbs[i]) - 1))
    return tuple(out)


def _push_left(ws: tuple, b, k: int) -> tuple:
    """Each k-mer's predecessor by base b: (u >> 2) | b << 2(k - 1)."""
    nbs = _word_bases(k)
    out = []
    for i, w in enumerate(ws):
        top = b if i == 0 else ws[i - 1] & np.uint64(3)
        out.append((w >> np.uint64(2)) | (top << np.uint64(2 * nbs[i] - 2)))
    return tuple(out)


def _base(ws: tuple, j: int, k: int) -> np.ndarray:
    """Base j (0 the first) of each k-mer, as uint8."""
    i = 0
    for nb in _word_bases(k):
        if j < nb:
            break
        j -= nb
        i += 1
    nb = _word_bases(k)[i]
    return ((ws[i] >> np.uint64(2 * (nb - 1 - j)))
            & np.uint64(3)).astype(np.uint8)


def _order(ws: tuple) -> np.ndarray:
    """The permutation that puts k-mers of word arrays `ws` in order (ties
    in any order): by the low word, then stably by each word above."""
    order = np.argsort(ws[-1])
    for w in ws[-2::-1]:
        order = order[np.argsort(w[order], kind="stable")]
    return order


def _find(table: tuple, query: tuple):
    """(index, found) of each query k-mer in the sorted distinct `table`
    (both word arrays): the first index whose k-mer is not below the
    query's, and whether it is the query's."""
    head = table[0]
    a = np.searchsorted(head, query[0], "left")
    if len(table) == 2:  # the low word, inside each run of equal hi
        b = np.searchsorted(head, query[0], "right")
        low, q = table[1], query[1]
        live = np.nonzero(a < b)[0]
        while len(live):
            mid = (a[live] + b[live]) // 2
            up = np.asarray(low[mid]) < q[live]
            a[live[up]] = mid[up] + 1
            b[live[~up]] = mid[~up]
            live = live[a[live] < b[live]]
    i = np.minimum(a, len(head) - 1)
    found = np.ones(len(a), bool)
    for w, q in zip(table, query):
        found &= np.asarray(w[i]) == q
    return a, found


def _classes(pair_tx, pair_start):
    """Class id of each k-mer from its sorted transcript list:
    numbered by first appearance in k-mer order, hashed and then checked
    member by member against the class's first k-mer."""
    cnt = np.diff(np.append(pair_start, len(pair_tx)))
    h1 = np.add.reduceat(_mix64(pair_tx + np.uint64(1)), pair_start)
    h2 = np.bitwise_xor.reduceat(
        _mix64(pair_tx * np.uint64(0x9E3779B97F4A7C15) + np.uint64(7)),
        pair_start)
    with np.errstate(over="ignore"):
        h = _mix64(h1 ^ (h2 * np.uint64(3)) ^ cnt.astype(np.uint64))
    _, first, inv = np.unique(h, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    ec = rank[inv]
    rep = first[inv]  # each k-mer's class representative
    if not (cnt == cnt[rep]).all():
        raise RuntimeError("class hash collision (sizes differ)")
    inpair = np.arange(len(pair_tx)) - np.repeat(pair_start, cnt)
    other = np.repeat(pair_start[rep], cnt) + inpair
    if not (pair_tx == pair_tx[other]).all():
        raise RuntimeError("class hash collision (members differ)")
    return ec.astype(np.int32)


def _unique_base(ext4: np.ndarray) -> np.ndarray:
    """Base of a 4-bit extension set with one member, else -1."""
    lut = np.array([-1, 0, 1, -1, 2, -1, -1, -1, 3, -1, -1, -1, -1, -1, -1,
                    -1], np.int64)
    return lut[ext4.astype(np.int64)]


def _joins(ws, exts, ec, k):
    """Each k-mer's join successor (index, -1 none), cycles cut."""
    n = len(ws[0])
    rb = _unique_base(exts & 15)
    lb = _unique_base(exts >> 4)
    src = np.nonzero(rb >= 0)[0]
    sw = tuple(w[src] for w in ws)
    succ, found = _find(ws, _push_right(sw, rb[src].astype(np.uint64), k))
    if not found.all():
        raise RuntimeError("an extension leads to no k-mer")
    firstb = _base(sw, 0, k).astype(np.int64)
    del sw
    ok = (lb[succ] == firstb) & (ec[src] == ec[succ]) & (succ != src)
    nxt = np.full(n, -1, np.int64)
    nxt[src[ok]] = succ[ok]
    # a chain of joins that never reaches a head is a cycle
    prv = np.full(n, -1, np.int64)
    has = nxt >= 0
    prv[nxt[has]] = np.nonzero(has)[0]
    up = np.where(prv >= 0, prv, np.arange(n))
    for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 1):
        up = up[up]
    cyc = np.nonzero(prv[up] >= 0)[0]
    if len(cyc):
        least = {}
        for i in cyc:  # cycles are rare: walk each one once
            if i in least:
                continue
            members, j = [], int(i)
            while j not in least and (not members or j != members[0]):
                members.append(j)
                j = int(nxt[j])
            m = min(members)
            for j in members:
                least[j] = m
        for j, m in least.items():
            if nxt[j] == m:
                nxt[j] = -1
    return nxt


def _chains(nxt):
    """(head index, offset from the head) of each k-mer's chain."""
    n = len(nxt)
    prv = np.full(n, -1, np.int64)
    has = nxt >= 0
    prv[nxt[has]] = np.nonzero(has)[0]
    up = np.where(prv >= 0, prv, np.arange(n))
    dist = (prv >= 0).astype(np.int64)
    while True:
        nd = dist + dist[up]
        nu = up[up]
        if (nu == up).all():
            return up, dist
        up, dist = nu, nd


def _bucket_ids(first: np.ndarray, starts: np.ndarray, k: int):
    """([positions] uint8, buckets): the first bases of the k-mer that
    starts at each position (`first`: its first word), packed, or
    NO_BUCKET where no k-mer of one transcript starts."""
    nb = _word_bases(k)[0]
    c = min(BUCKET_BASES, nb)
    bid = (first >> np.uint64(2 * (nb - c))).astype(np.uint8)
    # positions from a transcript's start to k - 1 bases before its end
    edge = np.zeros(len(bid) + 1, np.int8)
    full = np.diff(starts) >= k
    edge[starts[:-1][full]] += 1
    edge[starts[1:][full] - k + 1] -= 1
    bid[np.cumsum(edge[:-1], dtype=np.int8) == 0] = NO_BUCKET
    return bid, 4 ** c


def _distinct(bases, starts, k, pos, ws, tb):
    """The k-mers starting at the sorted positions `pos` (all of one
    bucket), of word arrays `ws`: (word arrays of the distinct k-mers in
    order, their extensions, each one's distinct transcripts in order,
    how many)."""
    total = len(bases)
    tx = np.searchsorted(starts, pos, "right") - 1
    first = pos == starts[tx]
    last = pos + k == starts[tx + 1]
    left = bases[np.maximum(pos - 1, 0)]
    right = bases[np.minimum(pos + k, total - 1)]
    ext = (np.where(first, 0, 16 << left)
           | np.where(last, 0, 1 << right)).astype(np.uint8)
    del first, last, left, right
    order = _order(ws)
    ws = tuple(w[order] for w in ws)
    newk = np.ones(len(pos), bool)
    for w in ws:
        newk[1:] &= w[1:] == w[:-1]
    newk[1:] = ~newk[1:]
    kstart = np.nonzero(newk)[0]
    exts = np.bitwise_or.reduceat(ext[order], kstart)
    rank = np.cumsum(newk) - 1
    key = (rank.astype(np.uint64) << np.uint64(tb)) | tx[order].astype(
        np.uint64)
    key.sort()  # sorted and deduplicated here: np.unique may hash
    keep = np.ones(len(key), bool)
    keep[1:] = key[1:] != key[:-1]
    key = key[keep]
    pair_tx = key & np.uint64((1 << tb) - 1)
    counts = np.bincount((key >> np.uint64(tb)).astype(np.int64),
                         minlength=len(kstart))
    return tuple(w[kstart] for w in ws), exts, pair_tx, counts


class RefGraph:
    """The arrays of the reference graph (see the module docstring).
    `kmers` is [n] uint64 up to k = 32, else [2, n]: the hi words, then
    the lo words, each row contiguous when loaded memory-mapped."""

    def __init__(self, k: int, arrays: dict):
        self.k = k
        for name in ARRAYS:
            setattr(self, name, arrays[name])
        self._seq_cache: dict[int, np.ndarray] = {}

    @classmethod
    def build(cls, bases: np.ndarray, starts: np.ndarray, k: int):
        nw = n_words(k)
        tb = max(1, (len(starts) - 2).bit_length())  # bits of a transcript
        every = _kmer_words(bases, k)  # at every position
        bid, n_buckets = _bucket_ids(every[0], starts, k)
        parts = []
        for b in range(n_buckets):
            pos = np.flatnonzero(bid == b)
            if len(pos).bit_length() + tb > 64:
                raise ValueError(f"{len(pos)} k-mers in one bucket with "
                                 f"{len(starts) - 1} transcripts: a "
                                 "(rank, transcript) key needs "
                                 f"{len(pos).bit_length() + tb} bits")
            if len(pos):
                parts.append(_distinct(bases, starts, k, pos,
                                       tuple(w[pos] for w in every), tb))
        del bid, every
        ws = tuple(np.concatenate([p[0][i] for p in parts])
                   for i in range(nw))
        exts = np.concatenate([p[1] for p in parts])
        pair_tx = np.concatenate([p[2] for p in parts])
        counts = np.concatenate([p[3] for p in parts])
        del parts
        pair_start = np.zeros(len(counts), np.int64)
        np.cumsum(counts[:-1], out=pair_start[1:])
        del counts
        ec = _classes(pair_tx, pair_start)
        del pair_tx, pair_start
        nxt = _joins(ws, exts, ec, k)
        head, off = _chains(nxt)
        del nxt
        n_k = len(ws[0])
        heads = np.nonzero(head == np.arange(n_k))[0]
        node_of_head = np.full(n_k, -1, np.int64)
        node_of_head[heads] = np.arange(len(heads))
        node = node_of_head[head]
        del node_of_head, head
        nlen_k = np.bincount(node, minlength=len(heads))
        node_len = nlen_k + (k - 1)
        seq_start = np.zeros(len(heads) + 1, np.int64)
        seq_start[1:] = np.cumsum(node_len)
        seq = np.zeros(int(seq_start[-1]), np.uint8)
        at = seq_start[node] + off
        seq[at] = _base(ws, 0, k)
        last = np.nonzero(off == nlen_k[node] - 1)[0]
        lastk = np.empty(len(heads), np.int64)
        lastk[node[last]] = last
        lw = tuple(w[last] for w in ws)
        for j in range(1, k):
            seq[at[last] + j] = _base(lw, j, k)
        del lw, at
        node_exts = ((exts[heads] & 0xF0)
                     | (exts[lastk] & 0x0F)).astype(np.uint8)
        r_edge = np.full((len(heads), 4), -1, np.int32)
        l_edge = np.full((len(heads), 4), -1, np.int32)
        for b in range(4):
            has_r = ((node_exts >> b) & 1).astype(bool)
            si, found = _find(ws, _push_right(
                tuple(w[lastk[has_r]] for w in ws), np.uint64(b), k))
            if not (found.all() and (off[si] == 0).all()):
                raise RuntimeError("a right edge leads to no node start")
            r_edge[has_r, b] = node[si]
            has_l = ((node_exts >> (4 + b)) & 1).astype(bool)
            pi, found = _find(ws, _push_left(
                tuple(w[heads[has_l]] for w in ws), np.uint64(b), k))
            if not (found.all()
                    and (off[pi] == nlen_k[node[pi]] - 1).all()):
                raise RuntimeError("a left edge leads to no node end")
            l_edge[has_l, b] = node[pi]
        return cls(k, {
            "kmers": ws[0] if len(ws) == 1 else np.stack(ws),
            "node": node.astype(np.int32),
            "off": off.astype(np.int32), "node_ec": ec[heads],
            "node_exts": node_exts, "node_len": node_len.astype(np.int32),
            "node_seq_start": seq_start, "node_seq": seq,
            "r_edge": r_edge, "l_edge": l_edge})

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        for name in ARRAYS:
            np.save(os.path.join(tmp, name + ".npy"), getattr(self, name))
        with open(os.path.join(tmp, "k"), "w") as f:
            f.write(str(self.k))
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "RefGraph":
        with open(os.path.join(path, "k")) as f:
            k = int(f.read())
        return cls(k, {name: np.load(os.path.join(path, name + ".npy"),
                                     mmap_mode="r") for name in ARRAYS})

    # -- what a read's walk asks of the graph -----------------------------

    @property
    def words(self) -> tuple:
        """The k-mers' word arrays, most significant first."""
        return (self.kmers,) if self.kmers.ndim == 1 else tuple(self.kmers)

    @property
    def n_kmers(self) -> int:
        return len(self.words[0])

    def lookup(self, value: int):
        """(node, offset) of the k-mer of integer value `value`, or None."""
        ws = self.words
        a, b = 0, len(ws[0])
        for i, w in enumerate(ws):  # the run of k-mers equal so far
            q = np.uint64((value >> (64 * (len(ws) - 1 - i))) & (2**64 - 1))
            a, b = (a + int(np.searchsorted(w[a:b], q, "left")),
                    a + int(np.searchsorted(w[a:b], q, "right")))
        if a < b:
            return int(self.node[a]), int(self.off[a])
        return None

    def contains(self, values: np.ndarray) -> np.ndarray:
        """Whether each of the k-mer values (as `kmer_values` gives them,
        flat: [m] or [m, 2]) is in the graph."""
        q = _columns(values, self.k)
        order = _order(q)
        _, found = _find(self.words, tuple(w[order] for w in q))
        out = np.empty(len(order), bool)
        out[order] = found
        return out

    def seq(self, node: int) -> np.ndarray:
        s = self._seq_cache.get(node)
        if s is None:
            a = int(self.node_seq_start[node])
            s = np.asarray(self.node_seq[a:a + int(self.node_len[node])])
            self._seq_cache[node] = s
        return s
