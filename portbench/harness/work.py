"""The least work each kernel's inputs need, and the card's peaks.

Counted from the functions' shapes and the seed index's definition, never
from a kernel's code (the arithmetic of chip_smoke.py's `bound` and
`*_work`, rewritten): each input byte read once, each output byte written
once, and per probe what the seed index's definition needs at least.

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3 and 67 T 32-bit
operations per second (at the full 700 W; the run prints the card's
power limit beside them).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12


def least_s(nbytes: float, ops: float) -> float:
    """The least seconds for the work: its bytes at the HBM peak or its
    operations at the integer peak, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)


def probe_positions(L: int, k: int, lazy: bool) -> int:
    """Positions K1 probes in a read of length L: with lazy seeds those of
    residue 0 (every third), else all L - k + 1."""
    P = L - k + 1
    return (P + 2) // 3 if lazy else P


def seed_work(B: int, L: int, k: int, seed_index: str, lazy: bool,
              probes: float, hits: float):
    """K1 (`seed_tables_cuda`): packed reads [B, ceil(L/16)] int32 and
    lens [B] int32 in, nh3 [B, L-k+1, 3] int32 out, and per probe:

    - cuckoo: a hit reads one 4-slot bucket of W-word keys and its
      (node, offset) pair; a miss reads both buckets;
    - mphf: a hit reads at least one level's bit word, the rank word, the
      stored key and the (node, offset); a miss at least one bit word.

    Operations: 3 per base to roll the k-mers, a 32-bit hash (9 per key
    word and 6 more) per bucket or level tried, a compare per key word
    read."""
    W = (2 * k + 31) // 32
    nw = (L + 15) // 16
    P = L - k + 1
    miss = probes - hits
    nbytes = B * nw * 4 + B * 4 + B * P * 12
    ops = 3 * B * L
    if seed_index == "cuckoo":
        nbytes += hits * (16 * W + 8) + miss * (2 * 16 * W)
        tried = hits + 2 * miss
        ops += tried * (9 * W + 6) + tried * 4 * W
    elif seed_index == "mphf":
        nbytes += hits * (4 + 4 + 4 * W + 8) + miss * 4
        ops += probes * (9 * W + 6) + hits * W
    else:
        raise ValueError(f"no work count for seed index {seed_index!r}")
    return nbytes, ops


def walk_work(B: int, L: int, dc: int, ec_bytes: int, cov_bytes: int,
              visits: float, coverage: float):
    """K2 (`walk_cuda`, compact output): the packed reads and lens, the
    first row of nh3 per read (12 bytes), a 48-byte node row per node
    visited, the pool bases compared (2 bits each, about the coverage),
    and the outputs (mapped, coverage, mismatches, n_nodes, ec_distinct).
    Operations: 6 per base compared and 20 per visit.  The lazy seeks'
    probes are left out: a lower bound."""
    nw = (L + 15) // 16
    out = B * (1 + cov_bytes + 4 + 4 + dc * ec_bytes)
    nbytes = B * nw * 4 + B * 4 + B * 12 + 48 * visits + coverage / 4 + out
    return nbytes, 6 * coverage + 20 * visits
