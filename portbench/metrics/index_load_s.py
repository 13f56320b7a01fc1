"""Layer: index load (serde.load_index, index/image.py).  Seconds of the
harness span around loading the cached index image."""


def read(run):
    return run.spans.get("index_load")
