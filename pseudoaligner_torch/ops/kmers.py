"""k-mer words for every read position (plain PyTorch).

Counterpart of `pseudoaligner_tpu.ops.kmers.all_kmers`: the [B, P, W]
word matrix (P = L - k + 1) built with k shift-or passes.  Word layout is
`dna.pack_kmers`': little-endian uint32 words, leftmost base most
significant.  Words are int64 holding uint32 values (see ops/hashing.py).
"""

from __future__ import annotations

import torch

from pseudoaligner_tpu.dna import kmer_words


def all_kmers(reads: torch.Tensor, k: int) -> torch.Tensor:
    """reads: [B, L] integer base codes -> [B, P, W] int64 k-mer words."""
    B, L = reads.shape
    P = L - k + 1
    if P < 1:
        raise ValueError(f"batch width {L} below k={k}")
    W = kmer_words(k)
    r = reads.to(torch.int64)
    words = [torch.zeros((B, P), dtype=torch.int64, device=reads.device)
             for _ in range(W)]
    for i in range(k):
        bitpos = 2 * (k - 1 - i)
        w, shift = bitpos // 32, bitpos % 32
        words[w] = words[w] | (r[:, i : i + P] << shift)
    return torch.stack(words, dim=-1)
