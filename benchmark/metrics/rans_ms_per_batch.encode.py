"""`coding.rans`: milliseconds of the compressor's `codec.encode_batch` a
batch in the traced pass, timed by the harness around each call."""


def read(rec):
    s = rec.slice
    spans = s.spans.get("rans") if s is not None else None
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
