"""Device operations (kernels, copies, fills) in the profiled slice over
its steps."""


def read(r):
    if r.kind != "train" or r.slice is None or not r.slice.device_ops:
        return None
    return len(r.slice.device_ops) / r.slice.units
