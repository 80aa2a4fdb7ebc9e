"""Dataset bitstream framing — bit-identical to the reference format.

The port's own copy of `lossyless_tpu/coding/bitstream.py`; files written by
either package are byte-identical.

Layout (reference `hub/compressor.py:192-196,258-275`):

    [n_records : uint32 BE]
    repeated n_records times:
        [length : uint32 BE][payload : length bytes]

`write_dataset`/`read_dataset` stream records so 100k+-image datasets never
materialize twice in memory.
"""

from __future__ import annotations

import contextlib
import struct
from pathlib import Path
from typing import Iterable, Iterator


@contextlib.contextmanager
def _as_fd(file, mode):
    """Accept a path or an already-open binary file-like object."""
    if hasattr(file, "read") or hasattr(file, "write"):
        yield file
    else:
        with Path(file).open(mode) as f:
            yield f


def write_uints(fd, values):
    fd.write(struct.pack(f">{len(values)}I", *values))


def write_bytes(fd, values: bytes):
    if len(values) == 0:
        return
    fd.write(values)  # struct '>Ns' packing would just copy the payload


def read_uints(fd, n):
    data = fd.read(n * 4)
    if len(data) != n * 4:
        raise ValueError(
            f"truncated record header: wanted {n * 4} bytes, got {len(data)}")
    return struct.unpack(f">{n}I", data)


def read_bytes(fd, n) -> bytes:
    data = fd.read(n)
    if len(data) != n:
        raise ValueError(f"truncated record: wanted {n} bytes, got {len(data)}")
    return data


def write_dataset(file, records: Iterable[bytes], n_records: int):
    with _as_fd(file, "wb") as f:
        write_uints(f, (n_records,))
        written = 0
        for b in records:
            write_uints(f, (len(b),))
            write_bytes(f, b)
            written += 1
        if written != n_records:
            raise ValueError(f"expected {n_records} records, wrote {written}")


def read_dataset(file) -> Iterator[bytes]:
    with _as_fd(file, "rb") as f:
        (n,) = read_uints(f, 1)
        for _ in range(n):
            (length,) = read_uints(f, 1)
            yield read_bytes(f, length)


def count_records(file) -> int:
    with _as_fd(file, "rb") as f:
        return read_uints(f, 1)[0]
