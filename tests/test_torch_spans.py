"""The port's program spans (`core.profiling.span`) on the CPU.

* With no profiler running, `span` is one shared no-op context and opens
  no `record_function`: with `record_function` made to raise, a
  `compress_dataset` and a fused training epoch still run.
* Under `profile_trace`, a tiny `ClipCompressor.compress_dataset` writes
  one `encode.pass` holding, a batch, one `encode.to_device`, one
  `encode.dispatch`, one `encode.readback_wait` and one
  `encode.rans_wait`, and `encode.write` inside `encode.tail`.
* A tiny ResNet-18 BINCE epoch writes one `train.forward`,
  `train.backward` and `train.optimizer` a step, one `nn.batchnorm` a
  BatchNorm call and as many `nn.batchnorm.backward`, each backward span
  holding the backward operators of its BatchNorm.
* The streams and the epoch's logs and parameters are the same with the
  profiler on and off.
"""

import json

import numpy as np
import pytest
import torch

from lossyless_tpu_torch.core import profiling
from lossyless_tpu_torch.hub.compressor import ClipCompressor
from lossyless_tpu_torch.nn.layers import BatchNorm
from lossyless_tpu_torch.nn.vit import VisionTransformer
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import run as trun
from lossyless_tpu_torch.train import state as tstate
from tests.test_torch_coding import random_eb_params
from tests import torch_threads  # noqa: F401  (one pool a worker)

RAW_HW = (40, 48)
BATCHES = (3, 3, 2)                 # a ragged last batch
EPOCH = ["encoder.z_dim=16", "distortion.project_dim=8",
         "online.arch_kwargs.hid_dim=16", "trainer.precision=fp32",
         "data_feat.kwargs.synthetic=True", "data_feat.kwargs.synthetic_n=12",
         "data_feat.batch_size=4"]
STEPS = 2


def _compressor() -> ClipCompressor:
    rng = np.random.default_rng(0)
    return ClipCompressor(
        random_eb_params(3), rng.normal(2.0, 0.3, 512).astype(np.float32),
        rng.normal(0.0, 0.1, 512).astype(np.float32),
        model=VisionTransformer(width=64, layers=2, heads=2,
                                dtype=torch.float32),
        dtype=torch.float32, raw_input_hw=RAW_HW, device="cpu")


def _compress(comp, path) -> bytes:
    raw = np.random.default_rng(1).integers(
        0, 256, (sum(BATCHES), *RAW_HW, 3), dtype=np.uint8)
    edges = np.cumsum((0,) + BATCHES)
    comp.compress_dataset(((raw[a:b], None) for a, b in
                           zip(edges[:-1], edges[1:])), path, is_info=False)
    return path.read_bytes()


def _epoch():
    """(state, epoch function) of a tiny `stl10_bince`: ResNet-18 with
    BatchNorm, the contrastive distortion, the factorized rate."""
    torch.manual_seed(0)
    cfg = tconfig.apply_overrides(tconfig.preset("stl10_bince"), EPOCH)
    ds = trun.instantiate_datamodule(cfg, cfg.data_feat)
    state = trun.build_state(cfg, STEPS, STEPS, device="cpu")
    return state, tstate.make_generative_epoch(
        ds.device_sampler(cfg.data_feat.batch_size), STEPS)


def _trace(path) -> list:
    """The trace's complete events, by start."""
    events = json.loads((path / profiling.TRACE_FILE).read_text())
    return sorted((e for e in events["traceEvents"] if e.get("ph") == "X"),
                  key=lambda e: e["ts"])


def _named(events, name) -> list:
    return [e for e in events if e["name"] == name]


def _inside(inner, outer) -> bool:
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_span_without_a_profiler_opens_nothing(monkeypatch, tmp_path):
    assert profiling.span("encode.pass") is profiling.span("train.forward")
    with profiling.profile_trace(tmp_path / "p"):
        assert isinstance(profiling.span("x"),
                          torch.profiler.record_function)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert _compress(_compressor(), tmp_path / "off.bin")
    state, epoch = _epoch()
    _, logs = epoch(state, 0)
    assert np.isfinite(logs["loss"]).all()


def test_encode_spans_and_streams(tmp_path):
    comp = _compressor()
    off = _compress(comp, tmp_path / "off.bin")
    with profiling.profile_trace(tmp_path / "p"):
        on = _compress(comp, tmp_path / "on.bin")
    assert on == off
    ev = _trace(tmp_path / "p")
    (whole,) = _named(ev, "encode.pass")
    n = len(BATCHES)
    for name in ("encode.to_device", "encode.dispatch",
                 "encode.readback_wait", "encode.rans_wait"):
        spans = _named(ev, name)
        assert len(spans) == n, name
        assert all(_inside(s, whole) for s in spans), name
    (tail,) = _named(ev, "encode.tail")
    (write,) = _named(ev, "encode.write")
    assert _inside(tail, whole) and _inside(write, tail)
    # the tail begins after the last batch is queued, and holds the last
    # batch's readback and the last coding wait
    assert tail["ts"] >= _named(ev, "encode.dispatch")[-1]["ts"]
    assert _inside(_named(ev, "encode.readback_wait")[-1], tail)
    assert _inside(_named(ev, "encode.rans_wait")[-1], tail)
    for d in _named(ev, "encode.dispatch"):
        assert any(e["name"] == "aten::round" and _inside(e, d) for e in ev)


def test_training_spans_and_logs(tmp_path):
    state, epoch = _epoch()
    _, off = epoch(state, 5)
    params_off = {k: v.clone() for k, v in state.model.state_dict().items()}

    state, epoch = _epoch()
    calls = []
    for m in state.model.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(lambda *a: calls.append(1))
    with profiling.profile_trace(tmp_path / "p"):
        _, on = epoch(state, 5)
    assert on.keys() == off.keys()
    for k in off:
        np.testing.assert_array_equal(on[k], off[k])
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, params_off[k]), k

    ev = _trace(tmp_path / "p")
    for name in ("train.sample", "train.forward", "train.backward",
                 "train.optimizer"):
        assert len(_named(ev, name)) == STEPS, name
    fwd, bwd = _named(ev, "nn.batchnorm"), _named(ev, "nn.batchnorm.backward")
    assert len(calls) > 0 and len(fwd) == len(calls) == len(bwd)
    steps = _named(ev, "train.forward")
    assert all(any(_inside(f, s) for s in steps) for f in fwd)
    # each backward span runs on autograd's thread inside the step's
    # backward and holds the operators that differentiate the norm
    backs = _named(ev, "train.backward")
    for b in bwd:
        assert any(b["ts"] >= s["ts"] and b["ts"] + b["dur"]
                   <= s["ts"] + s["dur"] for s in backs)
        assert any(e["name"].startswith("autograd::engine::evaluate_function:"
                                        " RsqrtBackward")
                   and e["tid"] == b["tid"] and _inside(e, b) for e in ev)


@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_backward_span_only_under_a_profiler(training, tmp_path):
    """The hooks are registered only on a profiled forward whose input
    needs a gradient: the unprofiled graph carries none."""
    bn = BatchNorm(4)
    x = torch.randn(3, 4, 5, 5, requires_grad=True)
    y = bn(x, training=training)
    assert not y._backward_hooks and not x._backward_hooks
    with profiling.profile_trace(tmp_path / "p"):
        y = bn(x, training=training)
        y.sum().backward()
    ev = _trace(tmp_path / "p")
    assert len(_named(ev, "nn.batchnorm")) == 1
    assert len(_named(ev, "nn.batchnorm.backward")) == 1
