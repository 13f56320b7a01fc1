"""Layer: K1 seed probe.  MiB of the next-hit table K1 writes for one
batch (the program's counters `pa.seed.nh3_bytes` over `pa.seed.tables`,
ops/map_kernel.py _map_packed): B * ceil(P/3) * 12 bytes under lazy
seeds, B * P * 12 under eager ones; nothing where the program has no span
registry or no such counter."""


def read(run):
    try:
        from pseudoaligner_torch import spans
    except ImportError:
        return None
    counters = spans.snapshot()["counters"]
    nbytes = counters.get("pa.seed.nh3_bytes")
    tables = counters.get("pa.seed.tables")
    if nbytes is None or not tables:
        return None
    return nbytes / tables / 2**20
