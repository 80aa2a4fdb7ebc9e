"""The `nn.vit` tower's eager dispatch: host milliseconds a batch of the
traced pass in the program's `encode.dispatch` span (the preprocess, the
tower, the affine and the rounding queued on the card, the readback
started), one span a batch."""

from benchmark import spans


def read(rec):
    s, batches = rec.slice, rec.info.get("slice_batches")
    if s is None or not batches:
        return None
    found = spans.counted(s, "encode.dispatch", len(batches))
    return None if found is None else spans.ms(found) / len(batches)
