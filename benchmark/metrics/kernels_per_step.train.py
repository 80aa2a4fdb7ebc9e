"""`train.state` (eager dispatch): device kernels in the traced steps over
their number."""


def read(rec):
    s = rec.slice
    if s is None or not s.kernels:
        return None
    return len(s.kernels) / rec.info["slice_steps"]
