"""Layer: step dispatch (ops/map_kernel.py map_batch and map_batch_packed,
host side).  The window's total host time inside the step's calls
(enqueue only; the step does not synchronise), per batch dispatched, in
ms."""


def read(run):
    if not run.tally.dispatched:
        return None
    return run.tally.dispatch_s / run.tally.dispatched * 1e3
