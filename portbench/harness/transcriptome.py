"""The synthetic transcriptome, made from a fixed seed.

Its counts are GENCODE human release 28's published ones (`genes`
genes holding `transcripts` transcripts); what the release's FASTA alone
could give -- the sequences, the lengths and how isoforms differ -- is
assumed: each gene is a family of `family_len` random bases, its first
isoform the family's sequence and each other one the sequence cut by one
internal deletion of `deletion` bases (ending 20 bases or more before
the family's end).  Isoforms per gene follow a
geometric law of the published mean (transcripts / genes), moved by one
at genes drawn from the seed until the total is exact.  The flat layout
(all bases concatenated, transcript starts) is what the traffic
generator, the index build and the reference read.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

RECIPE_VERSION = "gencode_counts-1"


def digest(recipe: dict, k: int) -> str:
    """Cache key of a transcriptome and everything built from it."""
    blob = json.dumps({"v": RECIPE_VERSION, "k": k, **recipe},
                      sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def isoform_counts(genes: int, transcripts: int, rng) -> np.ndarray:
    """[genes] isoforms per gene, each at least 1, summing to
    `transcripts`: geometric of mean transcripts / genes, then moved by
    one at genes drawn from `rng` until the sum is exact."""
    if transcripts < genes:
        raise ValueError("fewer transcripts than genes")
    n = rng.geometric(genes / transcripts, size=genes).astype(np.int64)
    while n.sum() != transcripts:
        d = int(transcripts - n.sum())
        if d > 0:
            np.add.at(n, rng.integers(0, genes, size=d), 1)
        else:
            many = np.nonzero(n > 1)[0]
            pick = np.unique(rng.choice(many, size=min(-d, len(many)),
                                        replace=False))
            n[pick] -= 1
    return n


def make(recipe: dict):
    """(list of uint8 code arrays, names, {name: gene}) of `recipe`."""
    lo, hi = recipe["family_len"]
    dlo, dhi = recipe["deletion"]
    if lo < 2 * dlo + 40:
        raise ValueError("families too short for their deletions")
    rng = np.random.default_rng(recipe["seed"])
    genes = int(recipe["genes"])
    iso = isoform_counts(genes, int(recipe["transcripts"]), rng)
    flen = rng.integers(lo, hi, size=genes)
    bases = rng.integers(0, 4, size=int(flen.sum())).astype(np.uint8)
    fstart = np.concatenate([[0], np.cumsum(flen)])
    seqs, names, gene_map = [], [], {}
    for g in range(genes):
        base = bases[fstart[g]:fstart[g + 1]]
        n = int(iso[g])
        a = rng.integers(0, len(base) // 2, size=n)
        b = np.minimum(a + rng.integers(dlo, dhi, size=n), len(base) - 20)
        for i in range(n):
            s = base if i == 0 else np.concatenate(
                [base[:a[i]], base[b[i]:]])
            name = f"tx{g}_{i}"
            seqs.append(s)
            names.append(name)
            gene_map[name] = f"gene{g}"
    return seqs, names, gene_map


class Flat:
    """All transcripts' bases in one array, with each one's start."""

    def __init__(self, bases: np.ndarray, starts: np.ndarray):
        self.bases = bases  # [total] uint8 codes 0-3
        self.starts = starts  # [n_tx + 1] int64, the last is `total`

    @property
    def n_tx(self) -> int:
        return len(self.starts) - 1

    def seq(self, t: int) -> np.ndarray:
        return self.bases[self.starts[t]:self.starts[t + 1]]

    @classmethod
    def of(cls, seqs) -> "Flat":
        starts = np.zeros(len(seqs) + 1, np.int64)
        starts[1:] = np.cumsum([len(s) for s in seqs])
        return cls(np.concatenate(seqs).astype(np.uint8), starts)

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp{os.getpid()}.npz"
        np.savez(tmp, bases=self.bases, starts=self.starts)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "Flat":
        with np.load(path) as z:
            return cls(z["bases"], z["starts"])
