"""Layer: aligner set-up, the index copies.  Seconds of the program's span
`pa.serve_init.h2d` (ops/map_kernel.py upload: every index array copied
from pageable host memory to the card, synchronous); nothing where the
program has no span registry."""


def read(run):
    try:
        from pseudoaligner_torch import spans
    except ImportError:
        return None
    s = spans.snapshot()["spans"].get("pa.serve_init.h2d")
    return None if s is None else s["total_s"]
