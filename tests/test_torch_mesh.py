"""`core/mesh.py`, the hub compressor over a mesh, and `trainer.n_devices`.

* The hub on `make_mesh(devices=["cpu"] * 4)` against `mesh=None` (the
  same streams, byte for byte, raw uint8 input and a ragged tail of 10
  images over 4 replicas included; features at JAX's test_hub_mesh.py
  1e-5) and against JAX's `ClipCompressor(mesh=make_mesh(4))` on the same
  tiny tower, seeded rate and images (JAX's mesh streams are its
  single-device streams; the port's symbols equal JAX's up to the
  boundary flips of test_torch_hub.py, at most 0.1%, and the streams are
  byte-equal wherever the symbols are).
* `trainer.n_devices` as JAX reads it (`_training_mesh`: 0 means every
  visible device, more than visible raises naming `n_devices`), JAX's
  `_fit_bsz` rounding, and `main` under `trainer.n_devices=2` through the
  pipeline's own spawn of 2 gloo ranks (the host-fed path) against
  `n_devices=1`, at JAX's pipeline-mesh tolerances (rtol 2e-4 / atol 2e-5,
  `n_bits` rtol 1e-3).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.core.mesh import make_mesh as jmake_mesh
from lossyless_tpu.hub.compressor import ClipCompressor as JClip
from lossyless_tpu.nn.vit import VisionTransformer as JViT
from lossyless_tpu.pipeline import run as jrun
from lossyless_tpu_torch.coding.bitstream import read_dataset
from lossyless_tpu_torch.core import mesh
from lossyless_tpu_torch.hub.compressor import ClipCompressor as TClip
from lossyless_tpu_torch.nn.vit import VisionTransformer as TViT
from lossyless_tpu_torch.nn.vit import params_from_flax
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import run as trun
from tests.test_torch_coding import random_eb_params
from tests import torch_threads  # noqa: F401  (one pool a worker)
from tests.torch_dist_worker import bounded

TINY = dict(patch_size=32, width=64, layers=2, heads=2, out_dim=512)
RAW_HW = (96, 96)
N_IMAGES = 10      # a ragged tail over a mesh of 4


@pytest.fixture(scope="module")
def hub():
    rng = np.random.default_rng(0)
    eb_params = random_eb_params(3)
    scaling = rng.normal(2.0, 0.3, 512).astype(np.float32)
    biasing = rng.normal(0.0, 0.1, 512).astype(np.float32)
    jmodel = JViT(dtype=jnp.float32, **TINY)
    flax = jax.tree.map(np.asarray, jmodel.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3), jnp.float32))[
        "params"])
    jcomp = JClip(eb_params, scaling, biasing, flax, dtype=jnp.float32,
                  model=jmodel, raw_input_hw=RAW_HW, mesh=jmake_mesh(4))

    def port(m):
        return TClip(eb_params, scaling, biasing, params_from_flax(flax),
                     dtype=torch.float32, device="cpu", raw_input_hw=RAW_HW,
                     model=TViT(dtype=torch.float32, **TINY), mesh=m)

    raw = rng.integers(0, 256, (N_IMAGES, *RAW_HW, 3), dtype=np.uint8)
    return dict(jcomp=jcomp, one=port(None),
                four=port(mesh.make_mesh(devices=["cpu"] * 4)), raw=raw)


def test_make_mesh():
    m = mesh.make_mesh(devices=["cpu"] * 4)
    assert m.size == 4 and all(d == torch.device("cpu") for d in m.devices)
    assert mesh.make_mesh(2, devices=["cpu"] * 4).size == 2
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="n_devices"):
            mesh.make_mesh(0)


def test_mesh_streams_equal_one_device(hub):
    raw = hub["raw"]
    s1, s4 = hub["one"].compress(raw), hub["four"].compress(raw)
    assert len(s4) == N_IMAGES and s4 == s1
    assert hub["four"].get_rate(raw) == hub["one"].get_rate(raw)
    np.testing.assert_allclose(hub["four"](raw), hub["one"](raw), rtol=1e-5,
                               atol=1e-5)
    # one replica a mesh entry, each its own copy of the tower
    reps = hub["four"]._replicas
    assert len(reps) == 4 and len({id(r.model) for r in reps}) == 4


def test_mesh_compress_dataset_equals_one_device(hub, tmp_path):
    raw = hub["raw"]
    batches = [(raw[:4], np.arange(4)), (raw[4:7], np.arange(4, 7)),
               (raw[7:], np.arange(7, 10))]     # ragged batches
    files = {}
    for name in ("one", "four"):
        f, lf = tmp_path / f"{name}.bin", tmp_path / f"{name}.npy"
        hub[name].compress_dataset(iter(batches), f, label_file=lf,
                                   is_info=False)
        files[name] = (f.read_bytes(), np.load(lf))
    assert files["four"][0] == files["one"][0]
    np.testing.assert_array_equal(files["four"][1], files["one"][1])


def test_mesh_streams_match_jax_mesh(hub):
    jc, tc, raw = hub["jcomp"], hub["four"], hub["raw"]
    jstreams, tstreams = jc.compress(raw), tc.compress(raw)
    jsym = jc.codec.decode_batch(jstreams, jc.indexes)
    tsym = tc.codec.decode_batch(tstreams, tc.indexes)
    assert (jsym != tsym).sum() <= 1e-3 * jsym.size
    same = np.all(jsym == tsym, axis=1)
    assert same.any()
    for i in np.flatnonzero(same):
        assert tstreams[i] == jstreams[i]


def _cfg(overrides):
    return tconfig.apply_overrides(tconfig.preset("banana_viz_VIC"),
                                   overrides)


def test_n_devices_all_and_validation():
    """JAX's test_pipeline_mesh.py check, with the port's visible count:
    on the CPU 0 (or -1) means one device, as JAX counts one CPU device,
    and an explicit count may reach the cores (a gloo rank is a
    process)."""
    cpu = torch.device("cpu")
    every, avail = mesh.visible_devices(cpu)
    assert every == 1
    for n in (0, -1):
        assert trun._training_mesh(_cfg([f"trainer.n_devices={n}"]),
                                   cpu) == 1
    assert trun._training_mesh(_cfg(["trainer.n_devices=2"]), cpu) == 2
    with pytest.raises(ValueError, match="n_devices"):
        trun._training_mesh(_cfg([f"trainer.n_devices={avail + 1}"]), cpu)
    with pytest.raises(ValueError, match="n_devices"):
        trun.main(_cfg([f"trainer.n_devices={avail + 1}"]), device="cpu")


@pytest.mark.parametrize("requested,n,n_devices", [
    (512, 2048, 1), (512, 2048, 8), (500, 2048, 8), (3, 2048, 8),
    (512, 5, 8), (7, 7, 2), (10, 1, 1)])
def test_fit_bsz_rounds_as_jax(requested, n, n_devices):
    assert trun._fit_bsz(requested, n, n_devices) == \
        jrun._fit_bsz(requested, n, n_devices)


def test_main_spawns_two_ranks_and_matches_one(tmp_path):
    """`main(trainer.n_devices=2)` spawns its 2 gloo ranks (the host-fed
    path: `trainer.use_fused_epochs=False`) and reproduces one device."""
    base = ["data_feat.n_epochs=1", "data_feat.kwargs.length=1024",
            "data_feat.batch_size=256", "data_feat.val_batch_size=256",
            "predictor.n_epochs=1", "encoder.arch_kwargs.hid_dim=16",
            "distortion.arch_kwargs.hid_dim=16",
            "trainer.use_fused_epochs=False"]
    runs = {}
    for n in (1, 2):
        with bounded():
            runs[n] = trun.main(_cfg(base + [
                f"trainer.n_devices={n}", f"out_dir={tmp_path}/{n}/out",
                f"ckpt_dir={tmp_path}/{n}/ck"]), device="cpu")
    m1, m2 = runs[1], runs[2]
    assert set(m1) == set(m2)
    for key in ("test/feat/loss", "test/feat/rate", "test/feat/distortion"):
        assert np.isfinite(m2[key])
        np.testing.assert_allclose(m2[key], m1[key], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(m2["test/comm/n_bits"],
                               m1["test/comm/n_bits"], rtol=1e-3)


def test_shard_batch_and_init_distributed(monkeypatch):
    x = torch.arange(12).reshape(6, 2)
    a, b = mesh.shard_batch((x, {"y": x[:, 0]}), 1, 3)
    torch.testing.assert_close(a, x[2:4])
    torch.testing.assert_close(b["y"], x[2:4, 0])
    with pytest.raises(ValueError, match="split"):
        mesh.shard_batch(x, 0, 4)
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert mesh.init_distributed("cpu") is False      # no torchrun env
    assert mesh.rank_world() == (0, 1) and mesh.active() is None
