"""95th percentile, over every batch done in the window, of the host-clock
time from handing the batch's codes to the step until its outputs are in
host memory, in ms."""

import numpy as np


def read(run):
    if not run.tally.latencies:
        return None
    return float(np.percentile(np.asarray(run.tally.latencies), 95)) * 1e3
