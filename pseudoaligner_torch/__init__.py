"""pseudoaligner_torch — the PyTorch + CUDA port of pseudoaligner_tpu.

The same pseudoalignment engine (kallisto/RapMap-style transcript
compatibility over a compacted de Bruijn graph), with the device step in
PyTorch and two hand-written CUDA kernels for NVIDIA Hopper:

    ops.map_kernel  the device index, the plain PyTorch seed and walk
                    passes, and `map_batch_packed`, which runs the CUDA
                    kernels on CUDA tensors and the plain passes on CPU
                    tensors
    ops.kernels     nvcc build at first use, ctypes binding and launch
                    counters of csrc/seed.cu (K1) and csrc/walk.cu (K2)
    models.aligner  the `Pseudoaligner` serving surface (single-end)
    cli             `index` and single-end `map`

The framework-free host layers (config, dna, serde, index building, FASTQ
and FASTA readers, the native C++ helpers, tcc, pipeline, golden) are
imported from pseudoaligner_tpu, which stays the reference.  This package
never imports jax.
"""

__version__ = "0.1.0"
