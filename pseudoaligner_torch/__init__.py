"""pseudoaligner_torch — the PyTorch + CUDA port of pseudoaligner_tpu.

The same pseudoalignment engine (kallisto/RapMap-style transcript
compatibility over a compacted de Bruijn graph), with the device step in
PyTorch and hand-written CUDA kernels for NVIDIA Hopper:

    ops.map_kernel   the device index (cuckoo, bucket1 or MPHF seed index,
                     optionally bit-packed on the link), the plain PyTorch
                     seed, walk, bitset-intersection and read-pack passes,
                     and `map_batch_packed` / `map_batch` /
                     `map_batch_with_seeds`, which run the CUDA kernels on
                     CUDA tensors and the plain passes on CPU tensors
    ops.mphf_lookup  the plain PyTorch MPHF probe and stored-key verify,
                     with static levels and with per-shard levels in tensors
    ops.stats        `batch_stats`: valid positions, hits, MPHF false
                     positives per batch
    ops.kernels      nvcc build at first use, ctypes binding and launch
                     counters of csrc/seed.cu (K1 and its next_hit entry),
                     walk.cu (K2), stats.cu (K3), ecbits.cu (K4 and its
                     entry from class ids), unpack.cu (K5), pack.cu (K6),
                     route.cu (K7), mphfdyn.cu (K8), txcounts.cu (K9),
                     gwalk.cu (K10) and gfetch.cu (K11)
    models.aligner   the `Pseudoaligner` serving surface: single-end and
                     paired emit (`emit_fastq`, `emit_batch`), record
                     paths, exact re-map of flagged reads
    singlecell       single-cell `count` (barcode/UMI R1, cDNA R2)
    parallel         the multi-device layer over torch.distributed (NCCL
                     between cards, gloo between CPU processes) or a
                     loopback mesh: data-parallel `ShardedAligner`, the
                     k-mer-partitioned `KmerPartitionedAligner` with the
                     graph replicated or, with `shard_graph=True`, split
                     into node blocks behind a routed fetch (the walk's
                     steps K10, the owner-side fetch K11), multi-process
                     `map_fastq_multihost` with its count merge, and the
                     dry run
    cli              `index`, single-end and paired `map`, `count`,
                     `mappability`, `idxstats`, `inspect`

The framework-free host layers (config, dna, serde, index building, the
FASTQ and FASTA readers, the native C++ helpers, tcc, pipeline, golden) are
this package's own copies of pseudoaligner_tpu's, which stays the
reference.  This package imports neither jax nor pseudoaligner_tpu.
"""

__version__ = "0.1.0"

from .config import AlignerConfig, DEFAULT_CONFIG  # noqa: F401
