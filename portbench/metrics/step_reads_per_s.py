"""Reads whose outputs reached host memory inside the window, per second
of the window (host clock)."""


def read(run):
    return run.tally.done * run.batch_reads / run.seconds
