"""Layer: aligner set-up, the seed table.  Seconds of the program's span
`pa.serve_init.table` (ops/map_kernel.py: build_cuckoo_fast or
build_bucket1 and the split into key rows and values); nothing where the
program has no span registry or built no table."""


def read(run):
    try:
        from pseudoaligner_torch import spans
    except ImportError:
        return None
    s = spans.snapshot()["spans"].get("pa.serve_init.table")
    return None if s is None else s["total_s"]
