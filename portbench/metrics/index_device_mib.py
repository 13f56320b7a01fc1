"""Layer: aligner set-up, the index as uploaded.  MiB of the device index
tensors (DeviceIndex.nbytes, each storage once)."""


def read(run):
    if run.index_device_bytes is None:
        return None
    return run.index_device_bytes / 2**20
