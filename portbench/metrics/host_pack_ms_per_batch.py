"""Layer: host hand-off (ops/map_kernel.py pack_reads_host, the aligner's
host pack in Pseudoaligner._step).  Milliseconds per batch of the
harness span around the program's host pack of each ring slot in set-up;
nothing where the reads cross the link as one-byte codes."""


def read(run):
    s = run.spans.get("host_pack")
    return None if s is None else s * 1e3
