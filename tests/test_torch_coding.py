"""Port coding layer against the JAX package: byte for byte.

rANS needs EXACT table equality to cross-decode and the dataset framing is
a wire format, so every comparison here is exact: framing bytes, quantized
CDFs, CDF tables under both arithmetics, streams (escapes included), and
decodes across the two packages.
"""

import io

import numpy as np
import pytest

from lossyless_tpu.coding import bitstream as jbs
from lossyless_tpu.coding import entropy_bottleneck as jeb
from lossyless_tpu.coding import rans as jrans
from lossyless_tpu_torch.coding import bitstream as tbs
from lossyless_tpu_torch.coding import entropy_bottleneck as teb
from lossyless_tpu_torch.coding import rans as trans
from lossyless_tpu_torch.nn import _build
from tests import torch_threads  # noqa: F401  (one pool a worker)


def random_eb_params(seed: int, channels: int = 512) -> dict:
    """Seeded entropy-bottleneck params in the checkpoint layout: the
    init_params values moved by seeded noise, and per-channel quantiles
    around a random median (so supports differ per channel)."""
    rng = np.random.default_rng(seed)
    filters = (1, 3, 3, 3, 1)
    p = {}
    for i in range(4):
        shape = (channels, filters[i + 1], filters[i])
        p[f"matrix{i}"] = (0.3 + rng.normal(0, 0.5, shape)).astype(np.float32)
        p[f"bias{i}"] = rng.uniform(-0.5, 0.5, (channels, filters[i + 1], 1)) \
            .astype(np.float32)
        if i < 3:
            p[f"factor{i}"] = rng.normal(
                0, 0.5, (channels, filters[i + 1], 1)).astype(np.float32)
    med = rng.normal(0, 0.5, channels)
    lo = med - rng.uniform(2, 12, channels)
    hi = med + rng.uniform(2, 12, channels)
    p["quantiles"] = np.stack([lo, med, hi], -1)[:, None, :].astype(
        np.float32)
    return p


@pytest.mark.parametrize("records", [[b"ab", b"c"],
                                     [b"hello", b"", b"\x00\x01" * 300]])
def test_framing_is_byte_equal(records):
    a, b = io.BytesIO(), io.BytesIO()
    jbs.write_dataset(a, records, len(records))
    tbs.write_dataset(b, records, len(records))
    assert a.getvalue() == b.getvalue()
    assert list(tbs.read_dataset(io.BytesIO(a.getvalue()))) == records
    assert tbs.count_records(io.BytesIO(a.getvalue())) == len(records)


def test_pmf_to_quantized_cdf_is_equal():
    rng = np.random.default_rng(0)
    for n in (2, 5, 40, 300):
        pmf = rng.random(n) ** 3 + 1e-7
        pmf = np.concatenate([pmf / pmf.sum() * (1 - 1e-6), [1e-6]])
        want = jrans.pmf_to_quantized_cdf(pmf)
        np.testing.assert_array_equal(trans.pmf_to_quantized_cdf(pmf), want)
        np.testing.assert_array_equal(
            trans._py_pmf_to_quantized_cdf(pmf.astype(np.float32)), want)


@pytest.mark.parametrize("arithmetic", ["float64", "compressai"])
def test_cdf_tables_are_equal(arithmetic):
    params = random_eb_params(1)
    want = jeb.build_cdf_tables(params, arithmetic)
    got = teb.build_cdf_tables(params, arithmetic)
    for field in ("quantized_cdf", "cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


@pytest.fixture(scope="module")
def codecs():
    t = teb.build_cdf_tables(random_eb_params(2), "compressai")
    args = (t.quantized_cdf, t.cdf_length, t.offset)
    return jrans.RansCodec(*args), trans.RansCodec(*args), t


def _symbols(t, seed, batch=6):
    """Symbols over each channel's support, plus escapes beyond +-max."""
    rng = np.random.default_rng(seed)
    lo = t.offset[None, :]
    hi = (t.offset + t.cdf_length - 3)[None, :]
    s = rng.integers(lo, hi + 1, (batch, len(t.offset)))
    s[0, :8] = hi[0, :8] + rng.integers(1, 1000, 8)        # above the max
    s[1, :8] = lo[0, :8] - rng.integers(1, 1000, 8)        # below the min
    s[2, 0], s[2, 1] = 2**31 - 1, -2**31                   # int32 extremes
    return s.astype(np.int32)


def test_streams_are_byte_equal_and_cross_decode(codecs):
    jc, tc, t = codecs
    idx = np.arange(len(t.offset), dtype=np.int32)
    sym = _symbols(t, 3)
    want = jc.encode_batch(sym, idx)
    got = tc.encode_batch(sym, idx)
    assert got == want
    np.testing.assert_array_equal(jc.decode_batch(got, idx), sym)
    np.testing.assert_array_equal(tc.decode_batch(want, idx), sym)
    one = tc.encode_with_indexes(sym[0], idx)
    assert one == jc.encode_with_indexes(sym[0], idx) == got[0]
    np.testing.assert_array_equal(tc.decode_with_indexes(one, idx), sym[0])


def test_native_matches_pure_python(codecs):
    _, tc, t = codecs
    rng = np.random.default_rng(4)
    idx = rng.integers(0, len(t.offset), 200).astype(np.int32)
    sym = _symbols(t, 5)[3][idx]
    sym[:3] = [5000, -5000, 2**31 - 1]
    data = tc.encode_with_indexes(sym, idx)
    assert data == trans._py_encode(sym, idx, tc.cdfs, tc.cdf_lengths,
                                    tc.offsets)
    np.testing.assert_array_equal(
        trans._py_decode(data, idx, tc.cdfs, tc.cdf_lengths, tc.offsets), sym)


def test_corrupt_stream_raises(codecs):
    _, tc, t = codecs
    idx = np.arange(len(t.offset), dtype=np.int32)
    with pytest.raises(ValueError, match="corrupt or truncated"):
        tc.decode_batch([b"\x00\x00"], idx)
    with pytest.raises(IndexError):
        tc.encode_batch(np.zeros((1, 2), np.int32), np.array([0, 10**6]))


def test_failed_build_raises(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setitem(_build.SOURCES, "rans", (src,))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native build failed"):
        _build.build("rans")
    assert not list((tmp_path / "build").glob("*.so*"))


def test_rans_builds_into_the_ports_build_directory():
    lib = trans._get_lib()
    path = _build.library_path("rans")
    assert lib._name == str(path) and path.exists()
    assert path.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parent.name == "lossyless_tpu_torch"
