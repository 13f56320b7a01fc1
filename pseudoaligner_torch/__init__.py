"""pseudoaligner_torch — the PyTorch + CUDA port of pseudoaligner_tpu.

The same pseudoalignment engine (kallisto/RapMap-style transcript
compatibility over a compacted de Bruijn graph), with the device step in
PyTorch and hand-written CUDA kernels for NVIDIA Hopper:

    ops.map_kernel   the device index (cuckoo, bucket1 or MPHF seed index),
                     the plain PyTorch seed and walk passes, and
                     `map_batch_packed`, which runs the CUDA kernels on CUDA
                     tensors and the plain passes on CPU tensors
    ops.mphf_lookup  the plain PyTorch MPHF probe and stored-key verify
    ops.stats        `batch_stats`: valid positions, hits, MPHF false
                     positives per batch
    ops.kernels      nvcc build at first use, ctypes binding and launch
                     counters of csrc/seed.cu (K1), csrc/walk.cu (K2) and
                     csrc/stats.cu (K3)
    models.aligner   the `Pseudoaligner` serving surface (single-end)
    cli              `index` and single-end `map`

The framework-free host layers (config, dna, serde, index building, the
FASTQ and FASTA readers, the native C++ helpers, tcc, pipeline, golden) are
this package's own copies of pseudoaligner_tpu's, which stays the
reference.  This package imports neither jax nor pseudoaligner_tpu.
"""

__version__ = "0.1.0"
