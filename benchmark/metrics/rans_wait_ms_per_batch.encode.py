"""`coding.rans`, its backpressure on the dispatching thread: host
milliseconds a batch of the traced pass in the program's
`encode.rans_wait` span (the wait for the previous batch's coding on the
rANS thread), one span a batch."""

from benchmark import spans


def read(rec):
    s, batches = rec.slice, rec.info.get("slice_batches")
    if s is None or not batches:
        return None
    found = spans.counted(s, "encode.rans_wait", len(batches))
    return None if found is None else spans.ms(found) / len(batches)
