"""MSP (minimum substring partitioning) super-k-mer sharding.

Equivalent of `debruijn::msp::simple_scan` + `partition_contigs` +
`group_by_slices` (reference: src/build_index.rs:93-151,227-244 [dep];
MSPKmerCounter, Li 2015).  This is the unit of build-time sharding (and of
the future k-mer-partitioned distributed index): every k-mer of a contig
lands in exactly one super-k-mer span, all occurrences of a given k-mer
share a bucket (the bucket is a function of the k-mer alone), and
`group_by_slices` never splits a bucket across shards.

The reference's p-mer ordering `PERM` is effectively the identity
permutation: `count_a_t_bases` (src/build_index.rs:116-125) compares 2-bit
codes (0-3) against ASCII 'A'/'T' (65/84) — never true — so the stable
sort keeps numeric order and bucket rank == p-mer value.  We use the
identity ordering directly.

Span boundaries: consecutive k-mers merge while their (leftmost) minimal
p-mer value is unchanged.  The final merged graph is invariant to the
exact span decomposition (SURVEY.md section 2.2 note); what this module
guarantees is the bucket function and the tiling properties above.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import PMER_K


def pmer_values(codes: np.ndarray, p: int = PMER_K) -> np.ndarray:
    """[n] base codes -> [n-p+1] uint32 p-mer values (identity ordering)."""
    c = np.asarray(codes, dtype=np.uint32)
    n = len(c)
    if n < p:
        return np.zeros(0, dtype=np.uint32)
    num = n - p + 1
    out = np.zeros(num, dtype=np.uint32)
    for i in range(p):
        out |= c[i : i + num] << np.uint32(2 * (p - 1 - i))
    return out


@dataclass
class MspInterval:
    bucket: int  # p-mer rank (u16 in the reference)
    start: int  # base offset of span start
    end: int  # base offset past span end (exclusive)

    @property
    def len(self) -> int:
        return self.end - self.start


def simple_scan(k: int, codes: np.ndarray, p: int = PMER_K) -> list[MspInterval]:
    """Split a contig into maximal super-k-mer spans sharing a minimizer.

    Each k-mer window's minimizer is its minimal p-mer value (leftmost on
    ties); consecutive windows with equal minimizer value merge.
    """
    n = len(codes)
    if n < k:
        return []
    pv = pmer_values(codes, p)
    win = k - p + 1
    # sliding-window min over pv with window `win`
    sw = np.lib.stride_tricks.sliding_window_view(pv, win)
    mins = sw.min(axis=1)  # [n-k+1]
    # span boundaries where the minimizer value changes
    change = np.nonzero(mins[1:] != mins[:-1])[0] + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(mins)]])
    return [
        MspInterval(bucket=int(mins[s]), start=int(s), end=int(e - 1 + k))
        for s, e in zip(starts, ends)
    ]


def slice_exts(codes: np.ndarray, start: int, length: int) -> int:
    """Exts of a contig slice's flanks (`Exts::from_dna_string`,
    reference call site src/build_index.rs:144 [dep]).  Bit layout as in
    index/image.py: bits 0..3 right, 4..7 left."""
    e = 0
    if start > 0:
        e |= 1 << (4 + int(codes[start - 1]))
    if start + length < len(codes):
        e |= 1 << int(codes[start + length])
    return e


def partition_contigs(
    codes: np.ndarray, contig_id: int, k: int
) -> list[tuple[int, int, tuple[int, int], int]]:
    """One contig -> [(bucket, contig_id, (start, end), exts), ...]
    (mirror of src/build_index.rs:127-151)."""
    if len(codes) < k:
        return []
    out = []
    for iv in simple_scan(k, codes):
        out.append((iv.bucket, contig_id, (iv.start, iv.end), slice_exts(codes, iv.start, iv.len)))
    return out


def group_by_slices(data, key_fn, min_size: int):
    """Split `data` into subslices of size > min_size that never split a
    run of equal keys (exact mirror of src/build_index.rs:227-244,
    including the strict `>` size comparison)."""
    slice_start = 0
    result = []
    for i in range(1, len(data)):
        d1, d2 = data[i], data[i - 1]
        if (i - slice_start) > min_size and key_fn(d1) != key_fn(d2):
            result.append(data[slice_start:i])
            slice_start = i
    if slice_start < len(data):
        result.append(data[slice_start:])
    return result
