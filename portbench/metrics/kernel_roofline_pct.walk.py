"""Layer: K2 (csrc/walk.cu, ops/kernels.py walk_cuda).  The least time of
a launch's work (harness/work.py walk_work) against the mean traced device
time per launch of K2's kernel seen in the window, in %."""

NAME = "::walk_kernel"


def read(run):
    if run.trace is None or "walk" not in run.work:
        return None
    durs = run.trace.kernel_durations(NAME)
    if not durs:
        return None
    from harness.work import least_s

    return 100.0 * least_s(*run.work["walk"]) / (sum(durs) / len(durs))
