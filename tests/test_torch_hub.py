"""Port hub ClipCompressor against the JAX ClipCompressor.

Both are built through their public constructors from the same seeded tiny
tower (flax init, handed to the port with `params_from_flax`), the same
seeded entropy-bottleneck params and affine, in fp32, on the same raw 96px
uint8 images (`raw_input_hw`, preprocess inside the encode).

Symbols may differ where a value lands within float roundoff of a .5
rounding boundary (the towers sum in different orders); the test counts
those flips, prints the count, and fails above 0.1% of symbols. Everything
downstream of identical symbols is exact: streams, dataset files and
decodes are byte-identical across the two packages.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.hub.compressor import ClipCompressor as JClip
from lossyless_tpu.nn.vit import VisionTransformer as JViT
from lossyless_tpu_torch import hub as thub
from lossyless_tpu_torch.coding.bitstream import read_dataset
from lossyless_tpu_torch.hub.compressor import ClipCompressor as TClip
from lossyless_tpu_torch.hub.load_reference import reference_path
from lossyless_tpu_torch.nn.vit import VisionTransformer as TViT
from lossyless_tpu_torch.nn.vit import params_from_flax
from tests.test_torch_coding import random_eb_params
from tests import torch_threads  # noqa: F401  (one pool a worker)

TINY = dict(patch_size=32, width=64, layers=2, heads=2, out_dim=512)
RAW_HW = (96, 96)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    eb_params = random_eb_params(3)
    scaling = rng.normal(2.0, 0.3, 512).astype(np.float32)
    biasing = rng.normal(0.0, 0.1, 512).astype(np.float32)
    jmodel = JViT(dtype=jnp.float32, **TINY)
    flax = jmodel.init(jax.random.key(0),
                       jnp.zeros((1, 224, 224, 3), jnp.float32))["params"]
    flax = jax.tree.map(np.asarray, flax)
    jcomp = JClip(eb_params, scaling, biasing, flax, dtype=jnp.float32,
                  model=jmodel, raw_input_hw=RAW_HW)
    args = (eb_params, scaling, biasing, params_from_flax(flax))
    kw = dict(dtype=torch.float32, device="cpu")
    tcomp = TClip(*args, model=TViT(dtype=torch.float32, **TINY),
                  raw_input_hw=RAW_HW, **kw)
    # the same compressor taking already-preprocessed images
    tcomp_pre = TClip(*args, model=TViT(dtype=torch.float32, **TINY), **kw)
    raw = rng.integers(0, 256, (8, *RAW_HW, 3), dtype=np.uint8)
    return dict(jcomp=jcomp, tcomp=tcomp, tcomp_pre=tcomp_pre, raw=raw,
                eb=(eb_params, scaling, biasing))


def _symbols(comp, streams):
    return comp.codec.decode_batch(streams, comp.indexes)


def test_symbols_match_up_to_boundary_flips(setup):
    jc, tc, raw = setup["jcomp"], setup["tcomp"], setup["raw"]
    jsym = _symbols(jc, jc.compress(raw))
    tsym = _symbols(tc, tc.compress(raw))
    flips = int((jsym != tsym).sum())
    print(f"symbol flips port vs JAX: {flips} of {jsym.size}")
    assert flips <= 1e-3 * jsym.size
    assert np.abs(jsym).max() > 2  # the symbols span more than a few bins


def test_streams_byte_equal_given_identical_symbols(setup):
    jc, tc, raw = setup["jcomp"], setup["tcomp"], setup["raw"]
    jstreams, tstreams = jc.compress(raw), tc.compress(raw)
    jsym = _symbols(jc, jstreams)
    assert tc.codec.encode_batch(jsym, tc.indexes) == jstreams
    same = np.all(jsym == _symbols(tc, tstreams), axis=1)
    assert same.any()
    for i in np.flatnonzero(same):
        assert tstreams[i] == jstreams[i]


def test_compress_dataset_files_byte_identical(setup, tmp_path):
    jc, tc = setup["jcomp"], setup["tcomp"]
    raw = setup["raw"]
    batches = [(raw[i:i + 3], np.arange(i, i + 3)) for i in (0, 3)] \
        + [(raw[6:], np.arange(6, 8))]      # a ragged last batch
    files = {}
    for name, comp in (("jax", jc), ("port", tc)):
        f, lf = tmp_path / f"{name}.bin", tmp_path / f"{name}.npy"
        comp.compress_dataset(iter(batches), f, label_file=lf, is_info=False)
        files[name] = (f.read_bytes(), np.load(lf))
    jbytes, tbytes = files["jax"][0], files["port"][0]
    np.testing.assert_array_equal(files["port"][1], files["jax"][1])
    assert tbytes[:4] == jbytes[:4]                  # record count
    jrec = list(read_dataset(io.BytesIO(jbytes)))
    trec = list(read_dataset(io.BytesIO(tbytes)))
    same = np.all(_symbols(jc, jrec) == _symbols(tc, trec), axis=1)
    assert same.any()
    for i in np.flatnonzero(same):
        assert trec[i] == jrec[i]
    if same.all():
        assert tbytes == jbytes


def test_streams_cross_decode(setup):
    jc, tc, raw = setup["jcomp"], setup["tcomp"], setup["raw"]
    jstreams, tstreams = jc.compress(raw), tc.compress(raw)
    np.testing.assert_array_equal(jc.decompress(tstreams),
                                  tc.decompress(tstreams))
    np.testing.assert_array_equal(tc.decompress(jstreams),
                                  jc.decompress(jstreams))


def test_decompress_dataset_roundtrip(setup, tmp_path):
    tc, raw = setup["tcomp"], setup["raw"]
    batches = [(raw[:4], np.arange(4)), (raw[4:], np.arange(4, 8))]
    f, lf = tmp_path / "z.bin", tmp_path / "y.npy"
    rate, _ = tc.compress_dataset(iter(batches), f, label_file=lf,
                                  is_info=False)
    z_hat, y = tc.decompress_dataset(f, label_file=lf, is_info=False,
                                     batch_size=3)
    assert z_hat.shape == (8, 512) and rate > 100
    np.testing.assert_array_equal(y, np.arange(8))
    np.testing.assert_array_equal(z_hat, tc.decompress(tc.compress(raw)))
    # decode equals the device-side dequantize path
    np.testing.assert_allclose(z_hat, tc(raw), atol=1e-5)
    assert tc.get_rate(raw) == pytest.approx(
        8 * sum(len(s) for s in tc.compress(raw)) / 8)


def test_raw_input_equals_preprocess_then_compress(setup):
    tc, tc_pre, raw = setup["tcomp"], setup["tcomp_pre"], setup["raw"]
    pre = TClip.preprocess_batch(raw)
    assert pre.shape == (8, 224, 224, 3) and pre.dtype == torch.float32
    assert tc_pre.compress(pre) == tc.compress(raw)


def test_decode_only_use_never_builds_the_tower(setup):
    eb_params, scaling, biasing = setup["eb"]
    streams = setup["tcomp"].compress(setup["raw"][:2])
    comp = TClip(eb_params, scaling, biasing, device="cpu")
    np.testing.assert_array_equal(comp.decompress(streams),
                                  setup["tcomp"].decompress(streams))
    assert all(p.is_meta for p in comp.model.parameters())


def test_default_device_raises_without_cuda(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TClip(*setup["eb"])


@pytest.mark.parametrize("beta", ["b001", "b005", "b01"])
def test_named_entry_points_need_the_published_weights(beta):
    if reference_path(beta).exists():
        pytest.skip("the published weights are present")
    with pytest.raises(FileNotFoundError):
        getattr(thub, f"clip_compressor_{beta}")(device="cpu")
