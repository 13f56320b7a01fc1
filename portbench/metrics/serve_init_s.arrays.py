"""Layer: aligner set-up, the index arrays.  Self seconds of the
program's span `pa.serve_init.arrays` (ops/map_kernel.py
device_index_from_image less its seed table: pool rows, node rows, EC
bitsets, the first touch of the mapped image); nothing where the program
has no span registry."""


def read(run):
    try:
        from pseudoaligner_torch import spans
    except ImportError:
        return None
    s = spans.snapshot()["spans"].get("pa.serve_init.arrays")
    return None if s is None else s["self_s"]
