"""The plain reference's per-read mapping, and the answer it expects.

One read at a time, in Python and NumPy, over `graph.RefGraph`, written
from the reference pseudoaligner's read mapping (src/pseudoaligner.rs:
64-319 of the debruijn_mapping project):

- a seed is the first k-mer found on positions 0, 3, 6, ...;
- when the seed lies at or past int(0.2 * L), a left extension walks back
  from it, segment by segment, with a budget of `allowed` mismatches per
  segment (the frame starts one base before the seed's offset, or at 0
  when the offset is 0), following left edges by the read's next base;
- the forward walk enters a node (+k coverage), compares the rest of the
  node with the read under the same per-segment budget, then follows the
  right edge of the read's next base (-(k-1) coverage), or re-seeds with
  the same stride-3 scan from where it stopped;
- mismatching bases count as coverage, except the one that breaks the
  budget; the visited nodes' classes, in push order, are the answer.

The serving shape caps the walk: `expected` says which reads a cap cuts
(their last class slot must read -3) and what the others' compact output
must be (the first `dc` runs of equal classes, the last slot -2 when there
are more runs).  The iteration counts follow the serving step's contract:
a left iteration per segment, a forward iteration per node entered and,
with lazy seeds, one per probe of a re-seed that starts off the stride-3
grid of position 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .graph import RefGraph, kmer_int, kmer_values

FLAG_RUNS = -2  # more class runs than slots
FLAG_CAPPED = -3  # a cap cut the walk


@dataclass
class Walk:
    cov: int = 0
    mm: int = 0
    classes: list = field(default_factory=list)  # pushed classes, in order
    left_iters: int = 0
    fwd_iters: int = 0


def _segment(ref: np.ndarray, read: np.ndarray, allowed: int):
    """(matched, mismatches added, budget broken) of one segment."""
    bad = np.flatnonzero(ref != read)
    if len(bad) > allowed:
        return int(bad[allowed]), allowed + 1, True
    return len(ref), len(bad), False


def walk_read(g: RefGraph, read: np.ndarray, allowed: int = 2,
              left_fraction: float = 0.2, lazy: bool = True) -> Walk:
    """The uncapped walk of one read of codes 0-3."""
    k = g.k
    L = len(read)
    w = Walk()
    if L < k:
        return w
    last_kmer = L - k
    vals = kmer_values(read, k)
    probes = [0]  # probes of lazy off-grid re-seeds

    def seed_from(pos: int, count: bool):
        while pos <= last_kmer:
            if count:
                probes[0] += 1
            hit = g.lookup(kmer_int(vals[pos]))
            if hit is not None:
                return pos, hit
            pos += 3
        return pos, None

    kpos, hit = seed_from(0, False)
    if hit is None:
        return w
    node, koff = hit

    if kpos >= int(np.float32(left_fraction) * np.float32(L)):
        last = kpos - 1
        pnode = node
        pko = koff - 1 if koff > 0 else 0
        while True:
            w.left_iters += 1
            m = min(last + 1, pko + 1)
            ref = g.seq(pnode)[pko - m + 1:pko + 1][::-1]
            rd = read[last - m + 1:last + 1][::-1]
            matched, add, broke = _segment(ref, rd, allowed)
            w.mm += add
            w.cov += matched
            if last + 1 - matched == 0 or broke:
                break
            last -= matched
            b = int(read[last])
            if not (int(g.node_exts[pnode]) >> (4 + b)) & 1:
                break
            pnode = int(g.l_edge[pnode, b])
            pko = int(g.node_len[pnode]) - k
            w.classes.append(int(g.node_ec[pnode]))

    while True:
        w.fwd_iters += 1
        kpos += k
        w.cov += k
        w.classes.append(int(g.node_ec[node]))
        ref_off = koff + k
        m = max(0, min(L - kpos, int(g.node_len[node]) - ref_off))
        matched, add, broke = _segment(
            g.seq(node)[ref_off:ref_off + m], read[kpos:kpos + m], allowed)
        w.mm += add
        w.cov += matched
        kpos += matched
        if kpos >= L:
            break
        b = int(read[kpos])
        if not broke and (int(g.node_exts[node]) >> b) & 1:
            node = int(g.r_edge[node, b])
            koff = 0
            kpos -= k - 1
            w.cov -= k - 1
            continue
        if kpos > last_kmer:
            break
        off_grid = lazy and kpos % 3 != 0
        probes[0] = 0
        kpos, hit = seed_from(kpos, off_grid)
        w.fwd_iters += probes[0]
        if hit is None:
            break
        node, koff = hit
    return w


def runs(classes: list) -> list:
    """The classes with runs of equal neighbours collapsed."""
    out = []
    for c in classes:
        if not out or out[-1] != c:
            out.append(c)
    return out


@dataclass(frozen=True)
class Shape:
    """The serving step's output shape and caps (MapMeta's fields)."""

    dc: int  # class slots
    wcap: int  # forward iterations
    lcap: int  # left iterations
    max_nodes: int
    allowed: int = 2
    left_fraction: float = 0.2
    lazy: bool = True


def expected(w: Walk, shape: Shape):
    """(capped, mapped, coverage, class slots) the serving step must give
    for a read whose uncapped walk is `w`; only the -3 flag is due when
    capped."""
    capped = (w.left_iters > shape.lcap or w.fwd_iters > shape.wcap
              or len(w.classes) > shape.max_nodes)
    r = runs(w.classes)
    dc = shape.dc
    slots = (r[:dc - 1] + [FLAG_RUNS]) if len(r) > dc else (
        r + [-1] * (dc - len(r)))
    return capped, bool(w.classes), w.cov, slots
