"""Layer: K1 (csrc/seed.cu, ops/kernels.py seed_tables_cuda).  The least
time of a launch's work (harness/work.py seed_work under the cell's seed
index) against the mean traced device time per launch of K1's kernel
seen in the window (traces drop launches), in %."""

NAME = "::seed_kernel"


def read(run):
    if run.trace is None or "seed" not in run.work:
        return None
    durs = run.trace.kernel_durations(NAME)
    if not durs:
        return None
    from harness.work import least_s

    return 100.0 * least_s(*run.work["seed"]) / (sum(durs) / len(durs))
