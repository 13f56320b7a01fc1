"""Layer: the link, codes in.  Bytes of the host-to-device copies the
trace saw in the window over their traced device time, in GB/s (1e9)."""


def read(run):
    if run.trace is None:
        return None
    seen = [(b, s) for b, s in run.trace.copies("HtoD") if b is not None]
    secs = sum(s for _, s in seen)
    if not seen or secs <= 0:
        return None
    return sum(b for b, _ in seen) / secs / 1e9
