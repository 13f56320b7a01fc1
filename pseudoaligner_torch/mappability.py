"""Transcriptome mappability analysis: host numpy, no device work.

The port's own copy of `pseudoaligner_tpu/mappability.py` (the port
imports nothing of that package): `mappability::analyze_graph` +
`write_mappability_tsv` of the reference (src/mappability.rs:33-156),
per-transcript 11-bin k-mer multiplicity histograms.  The reference's
per-node scalar loop becomes vectorized scatter-adds over the node
arrays and EC CSR (SURVEY.md §2.1: "trivially parallel segment-sum over
node arrays").
"""

from __future__ import annotations

import math
import os

import numpy as np

from .config import MAPPABILITY_COUNTS_LEN
from .index.image import IndexImage

MAPPABILITY_HEADER = (
    "tx_name\tgene_name\ttx_kmer_count\tfrac_kmer_unique_tx\tfrac_kmer_unique_gene\n"
)


def _bin_of(multiplicity: np.ndarray) -> np.ndarray:
    """Histogram bin index (reference: src/mappability.rs:57-71): bin
    multiplicity-1, saturating — note the reference's `>` comparison puts
    multiplicity == LEN and > LEN both in the last bin; preserved."""
    m = multiplicity.astype(np.int64)
    return np.where(m > MAPPABILITY_COUNTS_LEN, MAPPABILITY_COUNTS_LEN - 1, m - 1)


def analyze_graph(image: IndexImage):
    """Returns (tx_multiplicity [T, LEN], gene_multiplicity [T, LEN]) int64.

    Mirror of src/mappability.rs:120-156.
    """
    T = image.n_tx
    LEN = MAPPABILITY_COUNTS_LEN
    k = image.k
    M = image.n_ecs

    num_kmer = image.node_len.astype(np.int64) - k + 1

    # per-EC aggregate of node kmer counts
    kmers_per_ec = np.bincount(
        image.node_ec.astype(np.int64), weights=num_kmer, minlength=M
    ).astype(np.int64)

    # per-EC transcript and distinct-gene multiplicities
    ec_lens = np.diff(image.ec_offsets.astype(np.int64))
    ec_of_entry = np.repeat(np.arange(M), ec_lens)

    gene_names = [image.tx_gene_mapping[n] for n in image.tx_names]
    uniq_genes, gene_of_tx = np.unique(gene_names, return_inverse=True)
    entry_gene = gene_of_tx[image.ec_txs.astype(np.int64)]
    # distinct genes per EC: unique (ec, gene) pairs.  The reference counts
    # via `.unique()` on the iterator (itertools::unique — distinct overall,
    # order-preserving), same cardinality.
    pair = np.unique(np.stack([ec_of_entry, entry_gene], axis=1), axis=0)
    genes_per_ec = np.bincount(pair[:, 0], minlength=M).astype(np.int64)

    tx_bin_per_ec = _bin_of(ec_lens)
    gene_bin_per_ec = _bin_of(genes_per_ec)

    tx_mult = np.zeros((T, LEN), dtype=np.int64)
    gene_mult = np.zeros((T, LEN), dtype=np.int64)
    rows = image.ec_txs.astype(np.int64)
    w = kmers_per_ec[ec_of_entry]
    np.add.at(tx_mult, (rows, tx_bin_per_ec[ec_of_entry]), w)
    np.add.at(gene_mult, (rows, gene_bin_per_ec[ec_of_entry]), w)
    return tx_mult, gene_mult


def rust_f64_str(v: float) -> str:
    """Format a float exactly like Rust's `{}` Display for f64 (shortest
    roundtrip digits, never scientific notation, `NaN` for nan)."""
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    s = repr(float(v))
    if "e" in s or "E" in s:
        # expand scientific notation positionally
        mant, exp = s.lower().split("e")
        exp = int(exp)
        neg = mant.startswith("-")
        mant = mant.lstrip("-")
        if "." in mant:
            ip, fp = mant.split(".")
        else:
            ip, fp = mant, ""
        digits = ip + fp
        point = len(ip) + exp
        if point <= 0:
            out = "0." + "0" * (-point) + digits
        elif point >= len(digits):
            out = digits + "0" * (point - len(digits))
        else:
            out = digits[:point] + "." + digits[point:]
        s = ("-" if neg else "") + out
    if s.endswith(".0"):
        s = s[:-2]
    return s


def write_mappability_tsv(image: IndexImage, outdir: str) -> str:
    """Write tx_mappability.tsv (reference: src/mappability.rs:93-106).

    Row format: tx_name, gene_name, total_kmers, frac_unique_tx,
    frac_unique_gene (src/mappability.rs:81-90)."""
    tx_mult, gene_mult = analyze_graph(image)
    total = tx_mult.sum(axis=1)
    out_path = os.path.join(outdir, "tx_mappability.tsv")
    with open(out_path, "w") as f:
        f.write(MAPPABILITY_HEADER)
        for i, name in enumerate(image.tx_names):
            gene = image.tx_gene_mapping[name]
            # zero-kmer rows take the nan branch, so no divide warning
            # can fire
            fu_tx = tx_mult[i, 0] / total[i] if total[i] else float("nan")
            fu_gene = gene_mult[i, 0] / total[i] if total[i] else float("nan")
            f.write(
                f"{name}\t{gene}\t{total[i]}\t"
                f"{rust_f64_str(fu_tx)}\t{rust_f64_str(fu_gene)}\n"
            )
    return out_path
