"""Layer: aligner set-up, the host bit-pack.  Seconds of the program's
span `pa.serve_init.pack` (ops/map_kernel.py pack_serving_args, the
packed upload of a large cuckoo index); nothing where the program has no
span registry or packed nothing."""


def read(run):
    try:
        from pseudoaligner_torch import spans
    except ImportError:
        return None
    s = spans.snapshot()["spans"].get("pa.serve_init.pack")
    return None if s is None else s["total_s"]
