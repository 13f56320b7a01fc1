"""Layer: aligner set-up, the link.  MiB of cuckoo key rows that crossed
to the card as they are (the program's counter
`pa.serve_init.plain_key_bytes`, ops/map_kernel.py upload): at W = 4 the
packed upload bit-packs the values alone, and the 4-word rows ride plain;
nothing where the program has no span registry or no such counter."""


def read(run):
    try:
        from pseudoaligner_torch import spans
    except ImportError:
        return None
    n = spans.snapshot()["counters"].get("pa.serve_init.plain_key_bytes")
    return None if n is None else n / 2**20
