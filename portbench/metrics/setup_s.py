"""Seconds from the process's start to the window's start: imports, the
cached transcriptome and index, the aligner's set-up, the traffic ring and
the warm-up of the cell's own shapes (host clock)."""


def read(run):
    return run.setup_s
