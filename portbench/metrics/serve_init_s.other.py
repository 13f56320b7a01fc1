"""Layer: aligner set-up, the rest.  Self seconds of the program's span
`pa.serve_init` (models/aligner.py Pseudoaligner.__init__ less the spans
inside it: the arrays, the table, the pack, the copies, the kernels'
load); nothing where the program has no span registry."""


def read(run):
    try:
        from pseudoaligner_torch import spans
    except ImportError:
        return None
    s = spans.snapshot()["spans"].get("pa.serve_init")
    return None if s is None else s["self_s"]
