"""Shared data and comparison helpers of the PyTorch-port parity tests
(tests/test_torch_*.py): numpy-seeded synthetic transcriptomes and reads
fed to both the JAX reference and the port."""

import numpy as np
import torch

from pseudoaligner_tpu.index.builder import build_index

from .test_fuzz_parity import _fuzz_reads, _random_transcripts

__all__ = ["_fuzz_reads", "_random_transcripts", "family_transcripts",
           "polyt_transcripts", "make_batch", "port_index",
           "assert_results_equal", "write_fastq"]


def family_transcripts(rng, n_genes=6, n_iso=8, base_len=700):
    """Isoform families whose deletions cluster in one window: short
    unitigs with distinct classes, so walks cross many EC boundaries,
    compact outputs overflow (-2) and caps bite (-3)."""
    seqs, names, gmap = [], [], {}
    lo = base_len * 5 // 14
    for g in range(n_genes):
        base = rng.integers(0, 4, base_len).astype(np.uint8)
        for i in range(n_iso):
            a = int(rng.integers(lo, lo + 80))
            d = int(rng.integers(15, 60))
            s = base if i == 0 else np.concatenate([base[:a], base[a + d:]])
            nm = f"fam{g}_{i}"
            seqs.append(s)
            names.append(nm)
            gmap[nm] = f"fg{g}"
    return seqs, names, gmap


def polyt_transcripts(rng, n=10):
    """Random transcripts plus one with a 120-base poly-T run: at k = 64
    its all-ones k-mer is real and relocates to meta.ones_node."""
    seqs, names, gmap = _random_transcripts(rng, n=n, lo=200, hi=500)
    polyt = np.full(160, 3, dtype=np.uint8)
    polyt[:20] = rng.integers(0, 3, 20)
    polyt[140:] = rng.integers(0, 3, 20)
    return seqs + [polyt], names + ["POLYT"], {**gmap, "POLYT": "GPT"}


def build(seqs, names, gmap, k):
    return build_index(seqs, names, gmap, k=k)


def make_batch(reads, B, L):
    """[(id, codes)] -> codes [B, L] uint8, lens [B] int32 (zero padded
    rows past the reads)."""
    codes = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for j, (_, c) in enumerate(reads[:B]):
        codes[j, : len(c)] = c
        lens[j] = len(c)
    return codes, lens


def port_index(dev_np, meta):
    """The reference's numpy DeviceIndex/MapMeta -> the port's, on CPU."""
    from pseudoaligner_torch.ops.map_kernel import (
        from_jax_device_index,
        upload,
    )

    pdev, pmeta = from_jax_device_index(dev_np, meta)
    return upload(pdev, "cpu"), pmeta


def assert_results_equal(ref, got, what=""):
    """Every MapResult field equal, dtype and shape included."""
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        b = getattr(got, f)
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        assert a.shape == b.shape, (what, f, a.shape, b.shape)
        if not np.array_equal(a, b):
            rows = np.nonzero((a != b).reshape(a.shape[0], -1).any(1))[0]
            raise AssertionError(
                f"{what}: field {f} differs in rows {rows[:8].tolist()}: "
                f"ref {a[rows[:2]].tolist()} port {b[rows[:2]].tolist()}")


def write_fastq(path, reads):
    dec = "ACGT"
    with open(path, "wb") as f:
        for rid, w in reads:
            s = "".join(dec[b] for b in w)
            f.write(f"@{rid}\n{s}\n+\n{'I' * len(s)}\n".encode())
