"""First-hit seeding: K1's step form (csrc/seed.cu seed_kernel) and K2's
in-place re-seeds on it (csrc/walk.cu), against the whole table of the
plain seed pass and the plain walk, under each seed index (cuckoo,
bucket1, MPHF), every key width W = 1-4 (k = 15, 20, 33, 64), lazy and
eager seeds, P % 3 = 0, 1, 2 and reads exactly k long (one row).

The reads are built to reach every kind of read the step form tells
apart: exact windows (their position 0 hits, so K1 writes row 0 alone),
windows with substitution bursts past the mismatch budget and scattered
substitutions after the first k-mer (so such a read re-seeds, in place),
an error in the first k-mer (a later first hit: every row written),
random reads (no hit: row 0 alone), a transcript k-mer only at the last
residue-0 position or only off that grid, reversed windows and reads
shorter than k.

The card tests carry the `gpu` marker and skip without a CUDA device.
This file imports only the port, so it runs where jax is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_first_hit.py
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from pseudoaligner_torch import spans
from pseudoaligner_torch.config import AlignerConfig
from pseudoaligner_torch.index.builder import build_index
from pseudoaligner_torch.ops import kernels
from pseudoaligner_torch.ops import map_kernel as mk

MODES = ["cuckoo", "bucket1", "mphf"]
KS = [15, 20, 33, 64]  # W = 1, 2, 3, 4
# L - k: P % 3 = 0, 1, 2, and L = k (a single row); k = 64 reads 42 bases
# longer (150 at P % 3 = 0, the k = 64 cell's), since a read that maps
# from position 0 re-seeds only between k and L - k
EXTRA = {"P%3=0": 44, "P%3=1": 45, "P%3=2": 46, "L=k": 0}


def _read_len(k, extra):
    return k + EXTRA[extra] + (42 if k == 64 and EXTRA[extra] else 0)
SERVING = dict(distinct_cap=3, max_walk_iters=3, max_left_iters=2,
               max_nodes=7)


@functools.lru_cache(maxsize=None)
def _index(k):
    """Random transcripts, isoforms cut by deletions (branches and short
    unitigs), and a poly-T transcript (the all-ones k-mer at k = 64)."""
    rng = np.random.default_rng(2200 + k)
    seqs = [rng.integers(0, 4, int(rng.integers(250, 600))).astype(np.uint8)
            for _ in range(12)]
    for s in seqs[:6]:
        for _ in range(3):
            a = int(rng.integers(60, 140))
            seqs.append(np.concatenate(
                [s[:a], s[a + int(rng.integers(15, 60)):]]))
    seqs.append(np.full(200, 3, np.uint8))
    names = [f"t{i}" for i in range(len(seqs))]
    image = build_index(seqs, names, {n: f"g{i % 5}"
                                      for i, n in enumerate(names)}, k=k)
    return image, seqs


def _substitute(rng, w, positions):
    for p in positions:
        w[p] = (w[p] + 1 + rng.integers(0, 3)) % 4


def _reads(k, L, n=480):
    """Reads of every kind the step form tells apart (module docstring),
    at most L bases each."""
    _image, seqs = _index(k)
    rng = np.random.default_rng(k * 1000 + L)
    long = [s for s in seqs if len(s) >= L]
    P = L - k + 1
    last = 3 * ((P - 1) // 3)  # the last residue-0 position
    reads = []
    for i in range(n):
        s = long[int(rng.integers(len(long)))]
        st = int(rng.integers(0, len(s) - L + 1))
        w = s[st:st + L].copy()
        kind = i % 10
        if kind == 1 and L >= k + 8:  # a burst past the budget of 2
            a = int(rng.integers(k, L - 7))
            _substitute(rng, w, a + np.sort(rng.choice(7, 3, replace=False)))
        elif kind == 2 and L > k:  # scattered, after the first k-mer
            _substitute(rng, w, rng.integers(k, L, int(rng.integers(1, 6))))
        elif kind == 3:  # an error in the first k-mer
            _substitute(rng, w, rng.integers(0, k, 1))
        elif kind == 4:
            w = rng.integers(0, 4, L).astype(np.uint8)
        elif kind == 5:  # a transcript k-mer only at the last grid row
            w = rng.integers(0, 4, L).astype(np.uint8)
            w[last:last + k] = s[st:st + k]
        elif kind == 6 and P > 1:  # a transcript k-mer only off the grid
            w = rng.integers(0, 4, L).astype(np.uint8)
            w[1:1 + k] = s[st:st + k]
        elif kind == 7:
            w = w[::-1].copy()
        elif kind == 8:  # shorter windows, down to below k
            w = w[:int(rng.integers(k - 3, L + 1))].copy()
        reads.append(w)
    return reads


@functools.lru_cache(maxsize=None)
def _case(mode, k, extra, lazy):
    """(meta, index, packed reads, lens) on the card, padding rows last."""
    L = _read_len(k, extra)
    image, _seqs = _index(k)
    reads = _reads(k, L)
    cfg = AlignerConfig(k=k, max_read_len=L, seed_index=mode, **SERVING)
    dev_np, meta = mk.device_index_from_image(image, cfg)
    idx = mk.upload(dev_np, "cuda", serving=meta)
    meta = dataclasses.replace(meta, lazy_seeds=lazy)
    codes = np.zeros((len(reads) + 5, L), np.uint8)
    lens = np.zeros(len(codes), np.int32)
    for j, w in enumerate(reads):
        codes[j, :len(w)] = w
        lens[j] = len(w)
    packed = torch.from_numpy(mk.pack_reads_host(codes).view(np.int32))
    return meta, idx, packed.cuda(), torch.from_numpy(lens).cuda()


def _counter(name):
    return spans.snapshot()["counters"].get(name, 0)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


CASES = [(m, k, e, lazy) for m in MODES for k in KS for e in EXTRA
         for lazy in (True, False)]
IDS = [f"{m}-k{k}-{e}-{'lazy' if lazy else 'eager'}"
       for m, k, e, lazy in CASES]


@pytest.mark.gpu
@pytest.mark.parametrize("mode,k,extra,lazy", CASES, ids=IDS)
def test_step_form_rows_match_plain_on_cuda(mode, k, extra, lazy):
    """Row 0 of every read equals the plain table's, and every row of a
    read whose first hit lies past position 0; the batch holds reads of
    each kind (first hit 0, later, none)."""
    _need_cuda()
    meta, idx, packed, lens = _case(mode, k, extra, lazy)
    step = kernels.seed_tables_cuda(meta, idx, packed, lens, first_hit=True)
    full = mk.seed_tables(meta, idx, packed, lens)
    torch.cuda.synchronize()
    P = meta.n_positions
    assert step.shape == full.shape == (len(lens), meta.nh3_rows, 3)
    assert torch.equal(step[:, 0], full[:, 0])
    q0 = full[:, 0, 0]
    later = (q0 > 0) & (q0 < P)
    assert torch.equal(step[later], full[later])
    assert (q0 == 0).any() and (q0 == P).any()
    assert later.any() or P <= 3


@pytest.mark.gpu
@pytest.mark.parametrize("mode,k,extra,lazy", CASES, ids=IDS)
def test_step_form_walk_matches_plain_on_cuda(mode, k, extra, lazy):
    """K2 on the step form equals K2 on the whole plain table and the
    plain walk, every field: in the serving shape, in it with no mismatch
    budget (every substitution re-seeds, some at the walk cap), and in the
    uncapped full output with no budget.  Reads that map from position 0
    re-seed in place."""
    _need_cuda()
    meta, idx, packed, lens = _case(mode, k, extra, lazy)
    L = meta.read_len
    step = kernels.seed_tables_cuda(meta, idx, packed, lens, first_hit=True)
    full = mk.seed_tables(meta, idx, packed, lens)
    before = _counter("pa.walk.inplace_probes")
    exact = dataclasses.replace(meta, allowed_mismatches=0)
    whole = dataclasses.replace(exact, distinct_cap=0, max_walk_iters=0,
                                max_left_iters=0, max_nodes=2 * L)
    for m in (meta, exact, whole):
        got = kernels.walk_cuda(m, idx, packed, lens, step, first_hit=True)
        table = kernels.walk_cuda(m, idx, packed, lens, full)
        want = mk.walk(m, idx, packed, lens, full)
        torch.cuda.synchronize()
        for f in want._fields:
            a, b, c = getattr(got, f), getattr(table, f), getattr(want, f)
            assert a.dtype == c.dtype and a.shape == c.shape, f
            assert torch.equal(a, c), f
            assert torch.equal(b, c), f
    if L >= 2 * k + 3:  # room for an on-grid re-seed past the first k-mer
        assert _counter("pa.walk.inplace_probes") > before


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "eager"])
def test_seed_probes_count(mode, lazy):
    """pa.seed.probes moves by the probes K1 issued: on reads of the full
    length, 1 + (G - 1) for each read whose position 0 misses and 1 for
    each that hits; with shorter reads, a probe per row up to len - k of
    a read that misses at 0, one of one that hits, none below k."""
    _need_cuda()
    meta, idx, packed, lens = _case(mode, 20, "P%3=1", lazy)
    G, k = meta.nh3_rows, meta.k
    stride = 3 if lazy else 1
    full = mk.seed_tables(meta, idx, packed, lens)
    miss0 = full[:, 0, 0] != 0
    whole = lens == meta.read_len
    spans.reset()
    kernels.seed_tables_cuda(meta, idx, packed[whole].contiguous(),
                             lens[whole].contiguous(), first_hit=True)
    n_miss = int(miss0[whole].sum())
    assert 0 < n_miss < int(whole.sum())
    assert _counter("pa.seed.probes") == int(whole.sum()) + n_miss * (G - 1)
    spans.reset()
    kernels.seed_tables_cuda(meta, idx, packed, lens, first_hit=True)
    rows = torch.clamp((lens - k) // stride + 1, min=0, max=G)
    want = torch.where(miss0, rows, torch.clamp(rows, max=1)).sum()
    assert _counter("pa.seed.probes") == int(want)
    spans.reset()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_the_step_takes_the_step_form(mode):
    """map_batch_packed on the card launches K1's step form and K2 on it
    (the device counters move) and returns what the plain passes do."""
    _need_cuda()
    meta, idx, packed, lens = _case(mode, 20, "P%3=0", mode != "mphf")
    spans.reset()
    got = mk.map_batch_packed(meta, idx, packed, lens)
    want = mk.walk(meta, idx, packed, lens,
                   mk.seed_tables(meta, idx, packed, lens))
    counters = spans.snapshot()["counters"]
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert counters["pa.seed.reads"] == len(lens)
    assert 0 < counters["pa.seed.probes"] < len(lens) * meta.nh3_rows
    spans.reset()
