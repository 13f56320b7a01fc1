"""The scalar golden oracle, as a check of the port's `map` records.

`pseudoaligner_tpu.golden.GoldenAligner` (numpy and Python, no jax) walks
the index graph one read at a time, as the Rust pseudoaligner does: no
batches, kernels, caps or re-maps.  `golden_record` renders its answer as
the record `map` prints for that read, so a sample of a run's output can
be held byte for byte against it (chip_smoke.py does so on the GPU).

Reads longer than `config.max_read_len` are mapped by `map` as merged
windows; the oracle maps them whole, so hold only reads that fit a batch.
"""

from __future__ import annotations

import numpy as np

from pseudoaligner_tpu.config import AlignerConfig
from pseudoaligner_tpu.golden import GoldenAligner
from pseudoaligner_tpu.index.image import IndexImage

from .models.aligner import ReadRecord


def golden_oracle(image: IndexImage) -> GoldenAligner:
    """The oracle over `image`, probing the index per k-mer (no up-front
    k-mer map: the right trade when a sample of reads is checked)."""
    return GoldenAligner(image, lazy=True)


def golden_record(oracle: GoldenAligner, read_id: str, codes: np.ndarray,
                  config: AlignerConfig) -> str:
    """The line `map` prints for one read of base codes 0-3, by the
    oracle, under the reference's flag rule."""
    r = oracle.map_read_with_mismatch(
        np.asarray(codes, dtype=np.uint8), config.allowed_mismatches)
    eq, cov = ([], 0) if r is None else (r[0], r[1])
    flag = cov >= config.read_coverage_threshold and not eq
    return ReadRecord(flag, read_id, eq, cov).format_reference_style()
