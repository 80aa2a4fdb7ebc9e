"""`compress_dataset`'s tail (the last coding, `coding.bitstream`'s
`write_dataset`): milliseconds from the end of the traced pass's last
`encode.readback_wait` (the card's last batch back on the host) to the
end of its `encode.pass`, when the card has no work of the pass."""

from benchmark import spans


def read(rec):
    s, batches = rec.slice, rec.info.get("slice_batches")
    if s is None or not batches:
        return None
    passes = spans.counted(s, "encode.pass", 1)
    if passes is None:
        return None
    waits = spans.counted(s, "encode.readback_wait", len(batches))
    if waits is None:
        raise RuntimeError("an encode.pass span with no "
                           "encode.readback_wait in it")
    return 1e-3 * (passes[0].end - waits[-1].end)
