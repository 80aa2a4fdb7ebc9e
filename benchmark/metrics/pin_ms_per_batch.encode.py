"""`hub.compressor._to_device`: host milliseconds in `aten::pin_memory`
(the copy of a batch into pinned memory, with its own copy) a batch of the
traced pass."""


def read(rec):
    s, batches = rec.slice, rec.info.get("slice_batches")
    if s is None or not batches:
        return None
    t = s.host_s("aten::pin_memory")
    return 1e3 * t / len(batches) if t > 0 else None
