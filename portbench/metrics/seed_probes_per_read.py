"""Layer: K1 seed probe.  The probes K1 issued per read mapped (the
program's device counter `pa.seed.probes`, which K1's step form adds to
once a block, over its host counter `pa.seed.reads`, B a table;
ops/map_kernel.py _map_packed): the grid's rows a read under whole-table
seeding, fewer where reads stop at a first hit; nothing where the program
has no span registry or no such counters."""


def read(run):
    try:
        from pseudoaligner_torch import spans
    except ImportError:
        return None
    counters = spans.snapshot()["counters"]
    probes = counters.get("pa.seed.probes")
    reads = counters.get("pa.seed.reads")
    if probes is None or not reads:
        return None
    return probes / reads
