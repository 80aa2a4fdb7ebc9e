"""The port's `core/rng.py`, `core/timing.py`, `core/profiling.py`,
`data/norms.py` and the experiment CLI's `--profile-dir` / `--debug`,
against the JAX package where it has a counterpart.

* `tmp_seed`: the same draws inside the block as JAX's, numpy's state
  restored after it (and untouched with None);
* `norms`: the tables and `normalize` / `unnormalize` equal, and
  `data/images.py` reads the one copy;
* `Timer` and `device_timer` on the CPU (CPU tensors are done when
  dispatched: nothing to wait for);
* `profile_trace` writes a Chrome trace on the CPU; `device_memory_stats`
  is `{}` with no card; `debug_mode` raises at the op whose backward makes
  a NaN, and restores the previous setting;
* the CLI: `--profile-dir D` traces a run into `D/trace.json`, and under
  `-m` job i into `D/job{i}/trace.json`; `--debug` runs inside
  `debug_mode`.
"""

import json

import numpy as np
import pytest
import torch

from lossyless_tpu.core import rng as jrng
from lossyless_tpu.data import norms as jnorms
from lossyless_tpu_torch import cli as tcli
from lossyless_tpu_torch.core import profiling, timing
from lossyless_tpu_torch.core import rng as trng
from lossyless_tpu_torch.data import images as timages
from lossyless_tpu_torch.data import norms as tnorms
from tests.test_torch_banana import TINY
from tests import torch_threads  # noqa: F401  (one pool a worker)


def test_tmp_seed_matches_jax():
    draws = {}
    for name, mod in (("jax", jrng), ("port", trng)):
        np.random.seed(11)
        before = np.random.get_state()[1].copy()
        with mod.tmp_seed(5):
            inside = np.random.uniform(size=4)
        after = np.random.uniform(size=3)
        with mod.tmp_seed(None):
            untouched = np.random.uniform(size=2)
        draws[name] = (inside, after, untouched)
        np.random.seed(11)
        np.testing.assert_array_equal(np.random.get_state()[1], before)
    for a, b in zip(draws["jax"], draws["port"]):
        np.testing.assert_array_equal(a, b)
    np.random.seed(11)
    np.testing.assert_array_equal(np.random.uniform(size=3),
                                  draws["port"][1])


def test_norms_match_jax_and_images_reads_them():
    assert tnorms.MEANS == jnorms.MEANS and tnorms.STDS == jnorms.STDS
    assert timages.MEANS is tnorms.MEANS and timages.STDS is tnorms.STDS
    x = np.random.default_rng(0).uniform(size=(2, 5, 4, 3)).astype(
        np.float32)
    for name in ("cifar10", "clip", "galaxy"):
        y = tnorms.normalize(x, name)
        np.testing.assert_array_equal(y, jnorms.normalize(x, name))
        np.testing.assert_array_equal(tnorms.unnormalize(y, name),
                                      jnorms.unnormalize(y, name))


def test_timers_on_the_cpu():
    with timing.Timer() as t:
        sum(range(10000))
    assert t.duration > 0
    held = {}
    with timing.device_timer(held, "block", device="cpu"):
        torch.ones(4).sum()
    assert held["block"] > 0


def test_profile_trace_and_memory_stats_on_the_cpu(tmp_path):
    with profiling.profile_trace(tmp_path / "p"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    events = json.loads((tmp_path / "p" / profiling.TRACE_FILE).read_text())
    assert any("aten::mm" in e.get("name", "") for e in
               events["traceEvents"])
    with profiling.profile_trace(None):
        pass
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


def test_debug_mode_raises_at_the_op_that_makes_a_nan():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    assert not torch.is_anomaly_enabled()
    with profiling.debug_mode(True):
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="SqrtBackward0"), \
                pytest.warns(UserWarning):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()
    with profiling.debug_mode(False):
        torch.sqrt(x).sum().backward()       # NaN, no raise
    assert torch.isnan(x.grad).any()


def test_cli_profile_dir_and_debug(tmp_path, monkeypatch, capsys):
    base = ["--dev", "--device", "cpu", *TINY, "data_feat.n_epochs=1",
            f"out_dir={tmp_path}/out", f"ckpt_dir={tmp_path}/ckpt"]
    jobs = tcli.main(["banana_RD", "-m", *base, "loss.beta=0.05,0.2",
                      "--profile-dir", str(tmp_path / "trace")])
    assert [j["job"] for j in jobs] == [0, 1]
    assert sorted(p.name for p in (tmp_path / "trace").iterdir()) == \
        ["job0", "job1"]
    for i in range(2):
        trace = tmp_path / "trace" / f"job{i}" / profiling.TRACE_FILE
        assert json.loads(trace.read_text())["traceEvents"]
    entered = []
    real = profiling.debug_mode

    def recording(enable=True):
        entered.append(enable)
        return real(enable)

    monkeypatch.setattr(profiling, "debug_mode", recording)
    metrics = tcli.main(["banana_viz_VIC", "--debug", *base,
                         f"out_dir={tmp_path}/dbg"])
    assert entered == [True] and np.isfinite(metrics["test/feat/loss"])
    assert not torch.is_anomaly_enabled()
