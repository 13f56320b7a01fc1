"""Layer: aligner set-up (models/aligner.py Pseudoaligner.__init__:
device_index_from_image, map_kernel.upload, K5).  Seconds of the harness
span around the constructor, synchronised."""


def read(run):
    return run.spans.get("serve_init")
