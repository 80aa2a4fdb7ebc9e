"""The port's package exports, its torch.hub pair and its examples.

* every name of each JAX package's `__all__` (read from its `__init__.py`
  with `ast`) is exported by the port's counterpart and resolves, but for
  JAX's three named shardings of its mesh (`DATA_AXIS`, `data_sharding`,
  `replicated`), which the port leaves out;
* the exports load lazily: importing `analysis.kaggle` or
  `analysis.linear_eval` pulls in neither pandas nor matplotlib;
* `lossyless_tpu_torch/hubconf.py`: the `(compressor, transform)` pair
  refuses `pretrained=False` as JAX's does, raises `FileNotFoundError`
  without the published weights (also through `torch.hub.load`), and its
  transform equals JAX's `pil_clip_preprocess`;
* `examples/minimal_code_torch.py` on the CPU at a tiny size, its coded
  features equal to the dequantize path; `examples/hub_demo_torch.py`
  raises `FileNotFoundError` without the weights.
"""

import ast
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import hubconf as jhubconf
from lossyless_tpu.nn import vit as jvit
from lossyless_tpu_torch import hubconf as thubconf
from lossyless_tpu_torch.hub import load_reference as tref
from tests import torch_threads  # noqa: F401  (one pool a worker)

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = ["", "analysis", "coding", "compressors", "core", "data", "hub",
            "nn", "pipeline", "train"]
# JAX's NamedShardings of its mesh: no torch counterpart (ROADMAP queue 3)
KEPT_OUT = {"core": {"DATA_AXIS", "data_sharding", "replicated"}}


def _jax_all(sub: str) -> list[str]:
    path = ROOT / "lossyless_tpu" / sub / "__init__.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    raise AssertionError(f"{path} has no __all__")


@pytest.mark.parametrize("sub", PACKAGES, ids=lambda s: s or "root")
def test_the_port_exports_jaxs_names(sub):
    want = set(_jax_all(sub)) - KEPT_OUT.get(sub, set())
    pkg = importlib.import_module(
        "lossyless_tpu_torch" + (f".{sub}" if sub else ""))
    assert want <= set(pkg.__all__), want - set(pkg.__all__)
    assert len(set(pkg.__all__)) == len(pkg.__all__)
    for name in pkg.__all__:
        assert getattr(pkg, name) is not None, name
        assert name in dir(pkg)
    with pytest.raises(AttributeError):
        getattr(pkg, "no_such_name")


def test_only_the_mesh_shardings_are_left_out():
    left = {sub: set(_jax_all(sub)) - set(importlib.import_module(
        "lossyless_tpu_torch" + (f".{sub}" if sub else "")).__all__)
        for sub in PACKAGES}
    assert {k: v for k, v in left.items() if v} == KEPT_OUT


def test_exported_names_are_the_modules_own():
    from lossyless_tpu_torch import core, pipeline
    from lossyless_tpu_torch.core import math as tmath

    hypopt_module = importlib.import_module(
        "lossyless_tpu_torch.pipeline.hypopt")
    assert core.nats_to_bits(torch.tensor(tmath.LOG2)).item() == \
        pytest.approx(1.0)
    assert core.BASE_LOG == 2 and core.LOG2 == tmath.LOG2
    # the submodule's name does not shadow the exported function
    assert pipeline.hypopt is hypopt_module.hypopt


def test_the_exports_load_lazily():
    code = ("import sys; import lossyless_tpu_torch.analysis.kaggle, "
            "lossyless_tpu_torch.analysis.linear_eval, "
            "lossyless_tpu_torch.analysis, lossyless_tpu_torch.compressors; "
            "print(sorted(m for m in ('pandas', 'matplotlib', 'PIL', "
            "'lossyless_tpu_torch.pipeline.run') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# The torch.hub pair
# ---------------------------------------------------------------------------


@pytest.fixture()
def no_weights(monkeypatch, tmp_path):
    monkeypatch.setattr(tref, "REFERENCE_HUB", tmp_path / "hub")


@pytest.mark.parametrize("beta", ["b001", "b005", "b01"])
def test_hub_pair_refuses_unpretrained(beta, no_weights):
    with pytest.raises(ValueError) as want:
        getattr(jhubconf, f"clip_compressor_{beta}")(pretrained=False)
    with pytest.raises(ValueError) as got:
        getattr(thubconf, f"clip_compressor_{beta}")(pretrained=False)
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError):
        getattr(thubconf, f"clip_compressor_{beta}")(device="cpu")


def test_hub_pair_through_torch_hub(no_weights):
    assert thubconf.dependencies == ["torch", "numpy"]
    with pytest.raises(ValueError):
        torch.hub.load(str(ROOT / "lossyless_tpu_torch"),
                       "clip_compressor_b005", source="local",
                       pretrained=False)
    with pytest.raises(FileNotFoundError):
        torch.hub.load(str(ROOT / "lossyless_tpu_torch"),
                       "clip_compressor_b005", source="local",
                       device="cpu")


def test_hub_pair_transform_equals_jaxs(monkeypatch):
    import lossyless_tpu_torch.hub.compressor as tcompressor

    monkeypatch.setattr(tcompressor, "load_pretrained",
                        lambda beta, **kw: ("compressor", beta, kw))
    comp, transform = thubconf.clip_compressor_b01(device="cpu")
    assert comp == ("compressor", "b01", {"device": "cpu"})
    rng = np.random.default_rng(0)
    images = [Image.fromarray(rng.integers(0, 256, s + (3,), np.uint8))
              for s in ((50, 60), (240, 224), (31, 97))]
    images.append(rng.integers(0, 256, (80, 80, 3), np.uint8))
    got = transform(images)
    assert got.shape == (4, 224, 224, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jvit.pil_clip_preprocess(images))


# ---------------------------------------------------------------------------
# The examples
# ---------------------------------------------------------------------------


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_minimal_code_coded_round_trip_equals_dequantize():
    ex = _example("minimal_code_torch")
    z_tr, y_tr, z_te, y_te = ex.featurize(d=8, n_train=512, n_test=128)
    assert z_tr.shape == (512, 8) and z_te.shape == (128, 8)
    state = ex.train(z_tr, y_tr, n_epochs=2, device="cpu",
                     steps_per_epoch=5, batch=32)
    assert state.step == 10
    coder, streams, decoded = ex.code(state, z_te)
    assert len(streams) == 128
    np.testing.assert_allclose(decoded, ex.dequantize(coder, z_te),
                               rtol=1e-6, atol=1e-6)


def test_minimal_code_main_runs_on_the_cpu(monkeypatch, capsys):
    ex = _example("minimal_code_torch")
    real_train = ex.train
    monkeypatch.setattr(ex, "train", lambda *a, **kw: real_train(
        *a, steps_per_epoch=3, batch=32, **kw))
    bits, base, comp = ex.main(d=8, n_epochs=1, device="cpu")
    assert bits > 0 and 0 <= comp <= 1 and base > 0.5
    out = capsys.readouterr().out
    assert "coded rate:" in out and "probe acc:" in out


def test_feature_sampler_draws(monkeypatch):
    from lossyless_tpu_torch.data.features import FeaturesDataset

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(40, 6)).astype(np.float32)
    pos = rng.normal(size=(40, 6)).astype(np.float32)
    y = rng.integers(0, 5, 40)
    draws = {}
    for at in ("target", "input", "equiv_x"):
        ds = FeaturesDataset(feats, y, positives=pos, additional_target=at)
        sample = ds.device_sampler(16, device="cpu")
        x, yy, aux = sample(torch.Generator().manual_seed(3))
        idx = torch.randint(0, 40, (16,),
                            generator=torch.Generator().manual_seed(3))
        np.testing.assert_array_equal(x.numpy(), feats[idx.numpy()])
        np.testing.assert_array_equal(yy.numpy(), y[idx.numpy()])
        want = {"target": y, "input": feats, "equiv_x": pos}[at]
        np.testing.assert_array_equal(aux.numpy(), want[idx.numpy()])
        draws[at] = x
        again = sample(torch.Generator().manual_seed(3))[0]
        assert torch.equal(again, x)
    assert torch.equal(draws["target"], draws["equiv_x"])
    with pytest.raises(ValueError):
        FeaturesDataset(feats, y, additional_target="equiv_x") \
            .device_sampler(4, device="cpu")


def test_hub_demo_needs_the_published_weights(no_weights):
    ex = _example("hub_demo_torch")
    with pytest.raises(FileNotFoundError):
        ex.main(device="cpu")
