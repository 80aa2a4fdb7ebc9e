"""The classical codec baselines of the port against the JAX package.

* `ms_ssim` on the same random and smooth NHWC pairs, at sizes with 5
  scales and at sizes too small for them (fewer scales, a shrunk window);
* each mode's `batch_run` on the same uint8 batch: the same decoded
  images and every log but the two codec times;
* `evaluate` on float tensors against JAX's on the same float32 numpy
  arrays, with values one ulp under `k / 255`, which truncate to `k - 1`;
* `--classical` through both experiment CLIs on an MNIST preset with
  synthetic data: the same results CSV but the two codec times; the
  refusal under `-m`.
The figures must be equal, not close: the same bytes reach the same PIL.
"""

import csv

import numpy as np
import pytest
import torch
from PIL import features

from lossyless_tpu import cli as jcli
from lossyless_tpu.compressors import classical as jclassical
from lossyless_tpu_torch import cli as tcli
from lossyless_tpu_torch.compressors import classical as tclassical
from tests import torch_threads  # noqa: F401  (one pool a worker)

MODES = ["jpeg", "webp", "png", "identity"]
TIMES = ("compress_time", "receiver_time")


def _smooth(b, h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for _ in range(b):
        a, f = rng.uniform(0.2, 1.0, 2)
        img = 0.5 + 0.4 * np.sin(a * yy / 3 + f * xx / 5)
        out.append(np.stack([np.roll(img, i, axis=1) for i in range(c)], -1))
    return np.asarray(out)


@pytest.mark.parametrize("shape", [(2, 180, 180, 3), (2, 96, 96, 3),
                                   (3, 28, 28, 1), (2, 8, 8, 3),
                                   (1, 5, 7, 1)],
                         ids=["5scales", "96px", "28px", "8px", "5x7"])
@pytest.mark.parametrize("kind", ["random", "smooth"])
def test_ms_ssim_equals_jax(shape, kind):
    rng = np.random.default_rng(1)
    if kind == "random":
        x = rng.uniform(0, 1, shape)
    else:
        x = _smooth(*shape)
    y = np.clip(x + rng.normal(0, 0.05, shape), 0, 1)
    got = tclassical.ms_ssim(x, y)
    assert got == jclassical.ms_ssim(x, y)
    assert 0.0 < got < 1.0
    assert tclassical.ms_ssim(x, x) == jclassical.ms_ssim(x, x)


def test_ms_ssim_refusals_equal_jax():
    x = np.zeros((2, 8, 8, 3))
    for bad in (x[0], np.zeros((2, 8, 9, 3))):
        with pytest.raises(ValueError):
            jclassical.ms_ssim(x, bad)
        with pytest.raises(ValueError):
            tclassical.ms_ssim(x, bad)


def _batch(c: int):
    return (_smooth(3, 32, 40, c, seed=c) * 255).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_batch_run_equals_jax(mode, channels):
    if mode == "webp" and not features.check("webp"):
        pytest.skip("this PIL has no WebP")
    x = _batch(channels)
    want_hat, want = jclassical.ClassicalCompressor(mode=mode).batch_run(x)
    got_hat, got = tclassical.ClassicalCompressor(mode=mode).batch_run(x)
    np.testing.assert_array_equal(got_hat, want_hat)
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in TIMES} == \
        {k: v for k, v in want.items() if k not in TIMES}
    if mode in ("png", "identity"):
        assert got["mse"] == 0 and got["ms_ssim"] == pytest.approx(1.0)


def test_quality_and_factory_equal_jax():
    x = _batch(3)
    for q in (10, 95):
        _, want = jclassical.ClassicalCompressor("jpeg", q).batch_run(x)
        _, got = tclassical.get_classical_compressor(
            "jpeg", quality=q).batch_run(x)
        assert got["n_bits"] == want["n_bits"]
        assert got["ms_ssim"] == want["ms_ssim"]
    with pytest.raises(ValueError):
        tclassical.ClassicalCompressor("gif").compress_one(x[0])


def _under_k_over_255(seed: int):
    """float32 NHWC values one ulp under k / 255: numpy's float32 product
    by 255 lands under k, so the cast truncates them to k - 1."""
    rng = np.random.default_rng(seed)
    k = rng.integers(1, 256, (4, 24, 24, 3))
    exact = (k / 255.0).astype(np.float32)
    return np.nextafter(exact, np.float32(0)).astype(np.float32), k


@pytest.mark.parametrize("mode", ["jpeg", "png"])
def test_evaluate_float_tensors_equals_jax(mode):
    x, k = _under_k_over_255(2)
    as_bytes = tclassical.to_uint8(torch.from_numpy(x))
    assert (as_bytes.astype(int) == k - 1).mean() > 0.9   # truncated
    np.testing.assert_array_equal(
        as_bytes, (np.clip(x, 0, 1) * 255).astype(np.uint8))
    y = np.zeros(4)
    jbatches = [(x[:3], y[:3], y[:3]), (x[3:], y[3:], y[3:])]
    tbatches = [tuple(torch.from_numpy(a) for a in b) for b in jbatches]
    want = jclassical.ClassicalCompressor(mode=mode).evaluate(jbatches)
    got = tclassical.ClassicalCompressor(mode=mode).evaluate(tbatches)
    assert set(got) == set(want)
    assert all(k.startswith("test/feat/") for k in got)
    assert {k: v for k, v in got.items() if not k.endswith(TIMES)} == \
        {k: v for k, v in want.items() if not k.endswith(TIMES)}
    # uint8 batches pass through untouched
    u8 = [(as_bytes, y, y)]
    assert tclassical.ClassicalCompressor(mode=mode).evaluate(u8)[
        "test/feat/n_bits"] == jclassical.ClassicalCompressor(
            mode=mode).evaluate(u8)["test/feat/n_bits"]


MNIST = ["data_feat.kwargs.synthetic=True", "data_feat.kwargs.synthetic_n=64"]


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return dict(zip(rows[0], rows[1]))


@pytest.mark.parametrize("mode", ["jpeg", "identity"])
def test_cli_classical_csv_equals_jax(mode, tmp_path, capsys):
    out = {}
    for name, cli, dev in (("jax", jcli, []),
                           ("port", tcli, ["--device", "cpu"])):
        # JAX's parser wants the overrides before the options
        metrics = cli.main(["mnist_vic", *MNIST,
                            f"out_dir={tmp_path / name}",
                            f"ckpt_dir={tmp_path / name / 'ckpt'}",
                            "--classical", mode, *dev])
        found = sorted((tmp_path / name).rglob("results_featurizer.csv"))
        assert len(found) == 1, found
        assert f"_classical_{mode}/" in str(found[0])
        out[name] = (metrics, _read_csv(found[0]),
                     found[0].relative_to(tmp_path / name))
    (jm, jcsv, jpath), (tm, tcsv, tpath) = out["jax"], out["port"]
    assert tpath == jpath
    assert list(tcsv) == list(jcsv)
    assert {k: v for k, v in tcsv.items() if not k.endswith(TIMES)} == \
        {k: v for k, v in jcsv.items() if not k.endswith(TIMES)}
    assert set(tm) == set(jm)
    if mode == "identity":
        assert tm["test/feat/mse"] == 0.0
        assert tm["test/feat/ms_ssim"] == pytest.approx(1.0)
    printed = capsys.readouterr().out
    assert '"test/feat/n_bits"' in printed


def test_cli_classical_refuses_multirun(tmp_path):
    args = ["mnist_vic", *MNIST, "loss.beta=0.1,0.2", f"out_dir={tmp_path}",
            "-m", "--classical", "png"]
    with pytest.raises(SystemExit) as want:
        jcli.main(args)
    with pytest.raises(SystemExit) as got:
        tcli.main([*args, "--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "--classical is not supported with -m" in str(got.value)
    assert not list(tmp_path.rglob("*.csv"))
