"""Layer: aligner set-up, K5.  Device seconds of the program's span
`pa.serve_init.unpack` (CUDA events around K5's launch, csrc/unpack.cu,
ops/kernels.py unpack_index_cuda); nothing where the program has no span
registry or unpacked nothing."""


def read(run):
    try:
        from pseudoaligner_torch import spans
    except ImportError:
        return None
    s = spans.snapshot()["spans"].get("pa.serve_init.unpack")
    return None if s is None else s["total_s"]
