"""Layer: the kernels' library.  Seconds of the program's span
`pa.kernels.load` (ops/kernels.py _load: the source hash, nvcc where the
library is not built yet, the ctypes binding) at the first launch;
nothing where the program has no span registry or launched no kernel."""


def read(run):
    try:
        from pseudoaligner_torch import spans
    except ImportError:
        return None
    s = spans.snapshot()["spans"].get("pa.kernels.load")
    return None if s is None else s["total_s"]
