"""Transcript-compatibility-count (TCC) aggregation.

The reference prints per-read records only; its README cites TCC
clustering (Ntranos et al., README.md:9-12) as the intended downstream.
This module aggregates a mapping run into the kallisto-style TCC artifact:
an equivalence-class table (`output.ec`: class id -> comma-separated
transcript ids) and a count vector (`output.tsv`: class id -> read count).

Result classes are interned on the fly: a read's intersected class is
often one of the index's interned classes, but intersections across nodes
can create new sets (the reference materializes them per read as Vec<u32>,
src/pseudoaligner.rs:323-356).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class TccCounter:
    classes: dict[tuple[int, ...], int] = field(default_factory=dict)
    counts: list[int] = field(default_factory=list)
    n_reads: int = 0
    n_mapped: int = 0

    def add(self, eq_class: list[int] | tuple[int, ...], mapped: bool = True):
        """Count one read.  Unmapped reads (or empty classes) count toward
        n_reads only."""
        self.n_reads += 1
        if mapped:
            self.add_group(eq_class, 1)

    def add_group(self, eq_class, count: int = 1):
        """Intern `eq_class` and credit `count` mapped reads to it WITHOUT
        advancing n_reads — the bulk API for the signature-indirect emit
        path, which advances n_reads per batch (review r5: aligner.py
        used to reach into classes/counts directly and compensate add()'s
        read counting by hand)."""
        if not len(eq_class):
            return
        key = tuple(int(x) for x in eq_class)
        idx = self.classes.get(key)
        if idx is None:
            idx = len(self.counts)
            self.classes[key] = idx
            self.counts.append(0)
        self.counts[idx] += count
        self.n_mapped += count

    def merge(self, other: "TccCounter"):
        """Merge counts from another counter (e.g. another host's shard).
        classes-dict insertion order IS count-index order by construction,
        so the pairs zip directly (review r5: no inverse dict needed)."""
        self.n_reads += other.n_reads
        n_mapped = self.n_mapped  # add_group advances it by each count
        for key, c in zip(other.classes, other.counts):
            self.add_group(key, c)
        self.n_mapped = n_mapped + other.n_mapped

    def write(self, outdir: str, prefix: str = "output") -> tuple[str, str]:
        """Write `<prefix>.ec` and `<prefix>.tsv` (kallisto-style)."""
        ec_path = os.path.join(outdir, f"{prefix}.ec")
        tsv_path = os.path.join(outdir, f"{prefix}.tsv")
        with open(ec_path, "w") as f:
            for i, key in enumerate(self.classes):  # insertion order ==
                f.write(f"{i}\t{','.join(map(str, key))}\n")  # index order
        with open(tsv_path, "w") as f:
            for i, c in enumerate(self.counts):
                f.write(f"{i}\t{c}\n")
        return ec_path, tsv_path
