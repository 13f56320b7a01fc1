"""Per-batch seed statistics: valid positions, verified hits and MPHF
false positives.

Port of `pseudoaligner_tpu/ops/stats.py::batch_stats`.  Every valid k-mer
position of every read (p <= len - k) is probed in the MPHF and verified
against the stored key at its slot.  CUDA tensors go through the stats
kernel K3 (csrc/stats.cu); CPU tensors through `stats_counts`, the plain
PyTorch version.  Both need the MPHF and slot-ordered key arrays, which a
cuckoo or bucket1 serving upload carries as empty dummies.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .kmers import all_kmers
from .map_kernel import DeviceIndex, MapMeta, unpack_reads
from .mphf_lookup import probe_and_verify


@dataclass
class BatchStats:
    """Aggregate seed/probe statistics for one batch."""

    n_reads: int
    n_positions: int  # valid k-mer positions probed
    n_seed_hits: int  # verified index hits
    n_probe_false_positives: int  # MPHF slot returned but key mismatch
    seed_hit_rate: float
    fp_rate: float

    def as_dict(self):
        return self.__dict__.copy()


def stats_counts(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
                 lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: [3] int64 (valid positions, verified hits, false
    positives) of a packed [B, ceil(L/16)] int32 batch."""
    kmers = all_kmers(unpack_reads(packed, meta.read_len), meta.k)
    pos = torch.arange(meta.n_positions, device=packed.device)
    valid = pos[None, :] <= lens.to(torch.int64)[:, None] - meta.k
    slot, verified = probe_and_verify(kmers, idx.mphf_bits, idx.mphf_ranks,
                                      meta.mphf, idx.kmer_keys)
    return torch.stack([valid.sum(), (verified & valid).sum(),
                        ((slot >= 0) & ~verified & valid).sum()])


def batch_stats(meta: MapMeta, idx: DeviceIndex, packed: torch.Tensor,
                lens: torch.Tensor) -> BatchStats:
    """Seed statistics of one batch (packed reads and lens as for
    map_batch_packed).  Raises ValueError on an index without the MPHF and
    key arrays."""
    if idx.kmer_keys.shape[0] == 0 or idx.mphf_bits.shape[0] == 0:
        raise ValueError(
            "batch_stats needs the mphf/key arrays: pass a full "
            "DeviceIndex (upload without `serving`) — a cuckoo or bucket1 "
            "serving upload (Pseudoaligner.dev) carries them as dummies")
    if packed.is_cuda:
        from .kernels import stats_cuda

        counts = stats_cuda(meta, idx, packed, lens)
    else:
        counts = stats_counts(meta, idx, packed, lens)
    n_positions, n_hits, n_fp = (int(x) for x in counts.tolist())
    n_reads = int((lens > 0).sum())
    return BatchStats(
        n_reads=n_reads,
        n_positions=n_positions,
        n_seed_hits=n_hits,
        n_probe_false_positives=n_fp,
        seed_hit_rate=n_hits / n_positions if n_positions else 0.0,
        fp_rate=n_fp / n_positions if n_positions else 0.0,
    )
