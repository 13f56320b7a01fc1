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

`RefGraph.build` keeps the arrays a read's walk needs and `save`/`load`
keep them as .npy files (loaded memory-mapped).
"""

from __future__ import annotations

import os

import numpy as np

ARRAYS = ("kmers", "node", "off", "node_ec", "node_exts", "node_len",
          "node_seq_start", "node_seq", "r_edge", "l_edge")


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser, elementwise on uint64."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def kmer_values(bases: np.ndarray, k: int) -> np.ndarray:
    """[..., n] codes -> [..., n - k + 1] uint64 k-mer values."""
    n = bases.shape[-1] - k + 1
    v = np.zeros(bases.shape[:-1] + (max(n, 0),), np.uint64)
    c = bases.astype(np.uint64)
    for j in range(k):
        v <<= np.uint64(2)
        v |= c[..., j:j + n]
    return v


def _occurrences(bases, starts, k):
    """(value, tx, ext) of every k-mer occurrence of every transcript."""
    n_tx = len(starts) - 1
    vals = kmer_values(bases, k)
    lens = np.diff(starts)
    num = np.maximum(lens - k + 1, 0)
    pos = np.repeat(starts[:-1], num) + (
        np.arange(num.sum()) - np.repeat(np.cumsum(num) - num, num))
    tx = np.repeat(np.arange(n_tx, dtype=np.uint64), num)
    first = np.repeat(starts[:-1], num) == pos
    last = np.repeat(starts[1:], num) == pos + k
    ext = np.zeros(len(pos), np.uint64)
    left = np.where(first, 0, bases[np.maximum(pos - 1, 0)]).astype(np.uint64)
    ext |= np.where(first, np.uint64(0), np.uint64(16) << left)
    right = bases[np.minimum(pos + k, len(bases) - 1)].astype(np.uint64)
    ext |= np.where(last, np.uint64(0), np.uint64(1) << right)
    return vals[pos], tx, ext


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


def _joins(kmers, exts, ec, k):
    """Each k-mer's join successor (index, -1 none), cycles cut."""
    n = len(kmers)
    mask = np.uint64((1 << (2 * k)) - 1)
    rb = _unique_base(exts & np.uint64(15))
    lb = _unique_base(exts >> np.uint64(4))
    src = np.nonzero(rb >= 0)[0]
    succ_v = ((kmers[src] << np.uint64(2)) | rb[src].astype(np.uint64)) & mask
    succ = np.searchsorted(kmers, succ_v)
    if not (kmers[np.minimum(succ, n - 1)] == succ_v).all():
        raise RuntimeError("an extension leads to no k-mer")
    firstb = (kmers[src] >> np.uint64(2 * (k - 1))).astype(np.int64)
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


class RefGraph:
    """The arrays of the reference graph (see the module docstring)."""

    def __init__(self, k: int, arrays: dict):
        self.k = k
        for name in ARRAYS:
            setattr(self, name, arrays[name])
        self._seq_cache: dict[int, np.ndarray] = {}

    @classmethod
    def build(cls, bases: np.ndarray, starts: np.ndarray, k: int):
        tb = max(1, (len(starts) - 2).bit_length())  # bits of a transcript
        if 2 * k + tb > 64:
            raise ValueError(f"k={k} with {len(starts) - 1} transcripts: "
                             "the (k-mer, transcript) sort key needs "
                             f"{2 * k + tb} bits")
        v, tx, ext = _occurrences(bases, starts, k)
        # one sort for each k-mer's extensions, one for its transcripts
        ekey = np.sort((v << np.uint64(8)) | ext)
        del ext
        ev = ekey >> np.uint64(8)
        newk = np.ones(len(ekey), bool)
        newk[1:] = ev[1:] != ev[:-1]
        kstart = np.nonzero(newk)[0]
        kmers = ev[kstart]
        exts = np.bitwise_or.reduceat(ekey & np.uint64(0xFF), kstart)
        del ekey, ev, kstart
        key = np.sort((v << np.uint64(tb)) | tx)
        del v, tx
        newp = np.ones(len(key), bool)
        newp[1:] = key[1:] != key[:-1]
        key = key[newp]  # the distinct (k-mer, transcript) pairs
        kv = key >> np.uint64(tb)
        newk = np.ones(len(key), bool)
        newk[1:] = kv[1:] != kv[:-1]
        kidx = np.cumsum(newk) - 1
        pair_tx = key & np.uint64((1 << tb) - 1)
        del key, kv, newk, newp
        pair_start = np.searchsorted(kidx, np.arange(len(kmers)))
        ec = _classes(pair_tx, pair_start)
        del kidx, pair_tx, pair_start
        nxt = _joins(kmers, exts, ec, k)
        head, off = _chains(nxt)
        del nxt
        heads = np.nonzero(head == np.arange(len(kmers)))[0]
        node_of_head = np.full(len(kmers), -1, np.int64)
        node_of_head[heads] = np.arange(len(heads))
        node = node_of_head[head]
        del node_of_head, head
        nlen_k = np.bincount(node, minlength=len(heads))
        node_len = nlen_k + (k - 1)
        seq_start = np.zeros(len(heads) + 1, np.int64)
        seq_start[1:] = np.cumsum(node_len)
        seq = np.zeros(int(seq_start[-1]), np.uint8)
        at = seq_start[node] + off
        seq[at] = (kmers >> np.uint64(2 * (k - 1))).astype(np.uint8)
        last = np.nonzero(off == nlen_k[node] - 1)[0]
        lastk = np.empty(len(heads), np.int64)
        lastk[node[last]] = last
        for j in range(1, k):
            seq[at[last] + j] = ((kmers[last] >> np.uint64(2 * (k - 1 - j)))
                                 & np.uint64(3)).astype(np.uint8)
        node_exts = ((exts[heads] & np.uint64(0xF0))
                     | (exts[lastk] & np.uint64(0x0F))).astype(np.uint8)
        mask = np.uint64((1 << (2 * k)) - 1)
        r_edge = np.full((len(heads), 4), -1, np.int32)
        l_edge = np.full((len(heads), 4), -1, np.int32)
        for b in range(4):
            has_r = ((node_exts >> b) & 1).astype(bool)
            sv = ((kmers[lastk[has_r]] << np.uint64(2)) | np.uint64(b)) & mask
            si = np.searchsorted(kmers, sv)
            if not ((kmers[si] == sv).all() and (off[si] == 0).all()):
                raise RuntimeError("a right edge leads to no node start")
            r_edge[has_r, b] = node[si]
            has_l = ((node_exts >> (4 + b)) & 1).astype(bool)
            pv = (kmers[heads[has_l]] >> np.uint64(2)) | (
                np.uint64(b) << np.uint64(2 * (k - 1)))
            pi = np.searchsorted(kmers, pv)
            if not ((kmers[pi] == pv).all()
                    and (off[pi] == nlen_k[node[pi]] - 1).all()):
                raise RuntimeError("a left edge leads to no node end")
            l_edge[has_l, b] = node[pi]
        return cls(k, {
            "kmers": kmers, "node": node.astype(np.int32),
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
    def n_kmers(self) -> int:
        return len(self.kmers)

    def lookup(self, value: int):
        """(node, offset) of a k-mer value, or None."""
        i = int(np.searchsorted(self.kmers, np.uint64(value)))
        if i < len(self.kmers) and int(self.kmers[i]) == value:
            return int(self.node[i]), int(self.off[i])
        return None

    def contains(self, values: np.ndarray) -> np.ndarray:
        """Whether each of the uint64 k-mer values is in the graph."""
        order = np.argsort(values, kind="stable")
        sv = values[order]
        i = np.minimum(np.searchsorted(self.kmers, sv), len(self.kmers) - 1)
        out = np.empty(len(values), bool)
        out[order] = np.asarray(self.kmers[i]) == sv
        return out

    def seq(self, node: int) -> np.ndarray:
        s = self._seq_cache.get(node)
        if s is None:
            a = int(self.node_seq_start[node])
            s = np.asarray(self.node_seq[a:a + int(self.node_len[node])])
            self._seq_cache[node] = s
        return s
