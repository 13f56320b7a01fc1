"""The reference graph against a brute-force oracle at k from 1 to 64.

The oracle holds each k-mer as its bases, in a dict, and follows the
definition in reference/graph.py's docstring one k-mer at a time: its
transcripts and extensions, the joins, the chains (a cycle cut at its
least k-mer) and their nodes.  The transcriptome is made to hold what
the definition has special cases for: isoforms that share and branch,
reads of the other strand glued to a transcript, a tandem repeat (a
cycle of joins), and runs of one base (a k-mer that is its own
successor), among them the all-ones k-mer at k = 64."""

import hashlib
import os

import numpy as np
import pytest

from harness import transcriptome
from reference.graph import ARRAYS, RefGraph, kmer_int, kmer_values, n_words

RECIPE = {"recipe": "gencode_counts", "seed": 4, "genes": 30,
          "transcripts": 90, "family_len": [70, 300], "deletion": [5, 30]}
KS = [1, 2, 20, 31, 32, 33, 34, 63, 64]
# sha1 of the ten .npy files that the one-word build (before two-word
# k-mers) saved for the graph of _seqs() at k = 20
K20_DIGEST = "7f597b651c9ecb175384294a58cc8f56567834ce"


def _seqs():
    seqs, _, _ = transcriptome.make(RECIPE)
    rng = np.random.default_rng(4)
    extra = [np.tile(rng.integers(0, 4, 7).astype(np.uint8), 20),
             np.full(90, 3, np.uint8), np.full(70, 0, np.uint8)]
    for _ in range(6):
        a, b = (seqs[i] for i in rng.integers(len(seqs), size=2))
        extra.append(np.concatenate([3 - a[::-1][:60], b]).astype(np.uint8))
    return seqs + extra


@pytest.fixture(scope="module")
def world():
    seqs = _seqs()
    return seqs, transcriptome.Flat.of(seqs)


def _value(u: bytes) -> int:
    v = 0
    for c in u:
        v = 4 * v + c
    return v


def _oracle(seqs, k):
    """{k-mer bases: (node, offset)} and the nodes' arrays, by the
    definition, one k-mer at a time."""
    seen = {}
    for t, s in enumerate(seqs):
        s = bytes(s)
        for p in range(len(s) - k + 1):
            e = seen.setdefault(s[p:p + k], [set(), 0])
            e[0].add(t)
            if p > 0:
                e[1] |= 16 << s[p - 1]
            if p + k < len(s):
                e[1] |= 1 << s[p + k]
    kmers = sorted(seen)  # bases compare as the integers do
    ids = {}
    ec = {u: ids.setdefault(frozenset(seen[u][0]), len(ids)) for u in kmers}
    one = {1: 0, 2: 1, 4: 2, 8: 3}
    nxt = {}
    for u in kmers:
        r = one.get(seen[u][1] & 15)
        if r is None:
            continue
        v = u[1:] + bytes([r])
        if one.get(seen[v][1] >> 4) == u[0] and ec[u] == ec[v] and v != u:
            nxt[u] = v
    entered = set(nxt.values())
    chains, placed = [], set()
    for cycles in (False, True):
        for u in kmers:  # a cycle's least k-mer heads its chain
            if u in placed or (u in entered and not cycles):
                continue
            chain = [u]
            while chain[-1] in nxt and nxt[chain[-1]] != u:
                chain.append(nxt[chain[-1]])
            chains.append(chain)
            placed.update(chain)
    chains.sort()
    where = {u: (n, o) for n, c in enumerate(chains) for o, u in enumerate(c)}
    nodes = {"node_len": [], "node_ec": [], "node_exts": [], "node_seq": [],
             "r_edge": [], "l_edge": []}
    for c in chains:
        head, last = c[0], c[-1]
        nodes["node_len"].append(len(c) + k - 1)
        nodes["node_ec"].append(ec[head])
        ex = (seen[head][1] & 0xF0) | (seen[last][1] & 0x0F)
        nodes["node_exts"].append(ex)
        nodes["node_seq"].append(head + bytes(u[-1] for u in c[1:]))
        nodes["r_edge"].append([where[last[1:] + bytes([b])][0]
                                if ex >> b & 1 else -1 for b in range(4)])
        nodes["l_edge"].append([where[bytes([b]) + head[:-1]][0]
                                if ex >> (4 + b) & 1 else -1
                                for b in range(4)])
    return where, nodes


@pytest.mark.parametrize("k", KS)
def test_graph_equals_the_oracle(world, k):
    seqs, flat = world
    g = RefGraph.build(flat.bases, flat.starts, k)
    where, nodes = _oracle(seqs, k)
    assert g.n_kmers == len(where)
    assert g.kmers.shape == ((len(where),) if k <= 32 else (2, len(where)))
    stored = [kmer_int(w) for w in zip(*g.words)]
    assert stored == sorted(_value(u) for u in where)
    for u, at in where.items():
        assert g.lookup(_value(u)) == at
    for name in ("node_len", "node_ec", "node_exts", "r_edge", "l_edge"):
        assert np.asarray(getattr(g, name)).tolist() == nodes[name], name
    assert [bytes(g.seq(n)) for n in range(len(g.node_len))] == nodes[
        "node_seq"]
    # every k-mer of every transcript is in the graph; one with its last
    # base changed is where the oracle has it
    vals = np.concatenate([kmer_values(s, k) for s in seqs])
    assert g.contains(vals).all()
    near = [u[:-1] + bytes([(u[-1] + 1) % 4]) for u in sorted(where)[::37]]
    for u in near:
        assert g.lookup(_value(u)) == where.get(u)
    got = g.contains(np.concatenate([
        kmer_values(np.frombuffer(u, np.uint8), k) for u in near]))
    assert got.tolist() == [u in where for u in near]
    assert not got.all() or k <= 2


def test_all_ones_kmer_at_64(world):
    """The k-mer of 64 Ts holds every bit of both words; it is its own
    successor (no join) and sits last in the order."""
    seqs, flat = world
    g = RefGraph.build(flat.bases, flat.starts, 64)
    where, _ = _oracle(seqs, 64)
    ones = bytes([3] * 64)
    assert ones in where and _value(ones) == 2**128 - 1
    assert g.lookup(2**128 - 1) == where[ones]
    row = kmer_values(np.full(64, 3, np.uint8), 64)
    assert row.tolist() == [[2**64 - 1, 2**64 - 1]]
    near = row.copy()
    near[0, 1] ^= 1  # the last base T -> G
    assert g.contains(np.concatenate([row, near])).tolist() == [
        True, bytes([3] * 63 + [2]) in where]
    assert g.lookup(2**128 - 2) == where.get(bytes([3] * 63 + [2]))
    assert kmer_int(g.kmers[:, -1]) == 2**128 - 1


@pytest.mark.parametrize("k", [1, 20, 32, 33, 64])
def test_kmer_values_are_the_integers(k):
    codes = np.random.default_rng(k).integers(0, 4, (3, 90)).astype(np.uint8)
    v = kmer_values(codes, k)
    assert v.shape == (3, 91 - k) + (() if k <= 32 else (2,))
    for r in range(3):
        for p in (0, 7, 90 - k):
            assert kmer_int(v[r, p]) == _value(bytes(codes[r, p:p + k]))


@pytest.mark.parametrize("k", [0, 65])
def test_k_outside_1_to_64_is_refused(world, k):
    with pytest.raises(ValueError):
        n_words(k)
    with pytest.raises(ValueError):
        RefGraph.build(world[1].bases, world[1].starts, k)


def test_k20_graph_keeps_the_saved_layout(world, tmp_path):
    """At k = 20 the saved arrays are, byte for byte, those of the
    one-word build that came before two-word k-mers (its digest)."""
    g = RefGraph.build(world[1].bases, world[1].starts, 20)
    g.save(str(tmp_path / "g"))
    h = hashlib.sha1()
    for name in ARRAYS:
        with open(os.path.join(tmp_path, "g", name + ".npy"), "rb") as f:
            h.update(f.read())
    assert h.hexdigest() == K20_DIGEST



@pytest.mark.parametrize("k", [20, 64])
def test_hit_share_is_the_sampled_probes_found(world, k):
    """K1's hit sample looks each lazy probe (every third position) up
    through the same k-mer values as a read's walk does."""
    import torch

    from harness.session import _seed_work
    from reference.walk import Shape

    seqs, flat = world
    g = RefGraph.build(flat.bases, flat.starts, k)
    rng = np.random.default_rng(k)
    L = 100
    reads = np.stack([s[:L] for s in seqs if len(s) >= L][:40]
                     + [rng.integers(0, 4, L).astype(np.uint8)] * 10)
    reads[:5, 50] ^= 1
    shape = Shape(dc=3, wcap=5, lcap=2, max_nodes=9)
    (nbytes, _), share = _seed_work({"k": k, "seed_index": "cuckoo"},
                                    shape, g, [torch.from_numpy(reads)],
                                    len(reads), L)
    probes = [g.lookup(_value(bytes(r[p:p + k]))) is not None
              for r in reads for p in range(0, L - k + 1, 3)]
    assert share == pytest.approx(np.mean(probes), abs=1e-12)
    assert 0 < share < 1
    assert nbytes > 0
