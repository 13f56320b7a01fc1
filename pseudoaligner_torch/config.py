"""The mapping engine's configuration and the reference's constants.

The module-level constants mirror the reference's Rust consts
(reference: src/config.rs:1-23).  `AlignerConfig` is the port's own: a
frozen dataclass of what the port reads, with the reference's defaults,
so tests and the CLI can build other shapes.
"""

from __future__ import annotations

import dataclasses
import enum

# reference: src/config.rs:12-18
MEM_SIZE = 1
MIN_KMERS = 1
STRANDED = True
REPORT_ALL_KMER = False
READ_COVERAGE_THRESHOLD = 32
LEFT_EXTEND_FRACTION = 0.2
DEFAULT_ALLOWED_MISMATCHES = 2

# reference: src/config.rs:20
U32_MAX = 0xFFFFFFFF

# reference: src/config.rs:23
MAPPABILITY_COUNTS_LEN = 11

# Supported k sizes (reference: src/bin/pseudoaligner.rs:86-96 supports 20/64
# via monomorphized Kmer20/Kmer64).  Here k is a runtime parameter; 20 and 64
# are the validated configurations.
SUPPORTED_K = (20, 64)

# MSP p-mer length (reference: src/build_index.rs:93 `PmerType = Kmer6`).
PMER_K = 6

# Minimum number of super-kmer runs per build shard
# (reference: src/build_index.rs:25 MIN_SHARD_SEQUENCES).
MIN_SHARD_SEQUENCES = 2000


class FastaFormat(enum.Enum):
    """Transcriptome FASTA header formats (reference: src/config.rs:4-9)."""

    UNKNOWN = "unknown"
    GENCODE = "gencode"
    ENSEMBL = "ensembl"
    GFFREAD = "gffread"


@dataclasses.dataclass(frozen=True)
class AlignerConfig:
    """Runtime configuration for the mapping engine.

    The first four fields are the reference's mapping semantics.  The
    rest shape the device step and its outputs; the serving paths re-map
    exactly on the host the reads that a cap or a buffer cuts off.
    """

    k: int = 20
    allowed_mismatches: int = DEFAULT_ALLOWED_MISMATCHES
    left_extend_fraction: float = LEFT_EXTEND_FRACTION
    read_coverage_threshold: int = READ_COVERAGE_THRESHOLD

    # Reads a device step maps, and the widest read it holds; longer reads
    # are mapped as overlapping windows whose results merge on the host.
    batch_size: int = 8192
    max_read_len: int = 160
    # The walk's per-read buffer of pushed (node, class) pairs; a read
    # that pushes more is flagged -3 and re-mapped on the host.
    max_nodes: int = 64
    # Full output intersects a read's classes on the device, as transcript
    # bitsets (K4), when the transcriptome has at most this many
    # transcripts; above it, on the host.
    bitset_tx_threshold: int = 16384
    # Seed k-mer index: "cuckoo" (two 4-slot buckets), "bucket1" (one
    # 16-slot bucket of key and value slots) or "mphf" (BBHash with a
    # stored-key verify, the reference's NoKeyBoomHashMap: the least
    # memory).
    seed_index: str = "cuckoo"
    # Probe only residue-0 positions up front; a re-seed at another
    # residue probes inside the walk.  cuckoo and bucket1 only.
    lazy_seeds: bool = True
    # Compact output: per read, up to this many run-compacted class ids;
    # a read with more is flagged -2 and re-mapped on the host.  0 = full
    # output (node buffer and, under bitset_tx_threshold, EC bitsets).
    distinct_cap: int = 12
    # Forward-walk and left-extension iteration caps; a read cut off is
    # flagged -3 and re-mapped on the host.  The caps need the compact -3
    # channel, so they apply only when distinct_cap > 0.  0 = unbounded.
    max_walk_iters: int = 6
    max_left_iters: int = 2
    # Mapped batches kept in flight by the serving loops (pipeline.py)
    # before the oldest one's results are read back.
    pipeline_depth: int = 3

    def __post_init__(self):
        if self.k < 4 or self.k > 64:
            raise ValueError(f"k={self.k} out of supported range [4, 64]")


DEFAULT_CONFIG = AlignerConfig()
