"""The port's bench (`lossyless_tpu_torch.bench`) on the CPU.

Its timings mean something only on the card; here the tests hold what
does not depend on the card: the analytic FLOPs and the median against
the JAX bench's, the JPEG stager's bytes, the JSON keys of each mode (a
stub runs the measurement functions on the CPU at a tiny tower and
window), that the default mode's symbols are the compressor's, and that
`main` refuses to run without a card.
"""

import json
import sys

import numpy as np
import pytest
import torch

import bench as jbench
from lossyless_tpu_torch import bench
from lossyless_tpu_torch.hub.compressor import ClipCompressor
from lossyless_tpu_torch.nn.vit import VisionTransformer
from tests import torch_threads  # noqa: F401  (one pool a worker)

DEFAULT_KEYS = {"metric", "value", "unit", "vs_baseline", "value_spread",
                "runs", "input", "bits_per_img", "rate_is_synthetic",
                "decode_img_per_sec", "decode_vs_baseline", "decode_spread",
                "device_capacity_img_per_sec", "device_mfu",
                "flops_per_img", "whole_run_img_per_sec",
                "device_capacity_whole_run_img_per_sec"}
FED_KEYS = {"metric", "value", "unit", "vs_baseline", "value_spread",
            "runs", "input", "bits_per_img", "rate_is_synthetic",
            "decode_img_per_sec", "decode_vs_baseline", "device_mfu",
            "flops_per_img", "backend"}
TPU_KEYS = {"vs_north_star", "transfer_bound_tunnel"}


def _tiny():
    return VisionTransformer(width=64, layers=2, heads=2, out_dim=512,
                             dtype=torch.float32)


def test_flops_and_median_match_the_jax_bench():
    assert bench._tower_flops_per_img() == jbench._tower_flops_per_img()
    for vals in ([1.0], [1.0, 4.0], [1.0, 2.0, 9.0], [0.5, 1.5, 2.5, 7.0]):
        assert bench._median(vals) == jbench._median(vals)
    assert bench.PEAK_BF16_FLOPS == 989e12
    assert bench.BASELINE_IMG_PER_SEC == jbench.BASELINE_IMG_PER_SEC


def test_staged_jpegs_are_the_jax_benchs_bytes(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jp = jbench.stage_jpegs(tmp_path / "j", 3, 32)
    tp = bench.stage_jpegs(tmp_path / "t", 3, 32)
    assert [p.name for p in tp] == [p.name for p in jp]
    for a, b in zip(jp, tp):
        assert a.read_bytes() == b.read_bytes()


def _tiny_compressor(**kwargs):
    return ClipCompressor(*bench.synthetic_rate(), model=_tiny(),
                          device="cpu", **kwargs)


def test_device_resident_record_has_the_keys_on_a_cpu_stub():
    rec = bench.run_device_resident(_tiny_compressor(), batch=4,
                                    n_batches=2, runs=3)
    assert set(rec) == DEFAULT_KEYS and not set(rec) & TPU_KEYS
    assert rec["metric"] == "stl10_encode_throughput"
    assert rec["input"] == "device_resident" and rec["runs"] == 3
    assert rec["rate_is_synthetic"] is True
    assert rec["value_spread"][0] <= rec["value"] <= rec["value_spread"][1]
    assert rec["flops_per_img"] == round(bench._tower_flops_per_img())
    assert rec["device_mfu"] == pytest.approx(
        rec["value"] * bench._tower_flops_per_img() / 989e12, abs=1e-4)
    assert rec["bits_per_img"] > 0 and rec["decode_img_per_sec"] > 0
    assert rec["whole_run_img_per_sec"] > 0
    assert rec["device_capacity_whole_run_img_per_sec"] > 0
    json.dumps(rec)


def test_a_window_is_the_compressors_symbols():
    """The window's symbols are `ClipCompressor._encode_symbols` of its
    normalized batches, narrowed to int8; the bf16 normalize is CLIP's to
    bf16 rounding; the readback is the compressor's."""
    from lossyless_tpu_torch.nn.vit import CLIP_MEAN, CLIP_STD

    comp = _tiny_compressor()
    enc = bench.DeviceEncoder(comp, batch=3, n_batches=2)
    syms, over = enc.wait(enc.dispatch(7))
    assert syms.dtype == torch.int8 and syms.shape == (2, 3, 512)
    with torch.inference_mode():
        for i in range(2):
            x = enc.normalize(i, 7)
            want = comp._encode_symbols(x)
            assert int(over) == 0 and want.abs().max() <= 126
            assert torch.equal(syms[i].to(torch.int32), want)
            clip = ((enc.data[i] ^ 7).float() / 255.0
                    - torch.as_tensor(CLIP_MEAN)) / torch.as_tensor(CLIP_STD)
            # two bf16 roundings of values below 2.2 in magnitude
            assert torch.allclose(x.float(), clip, rtol=0, atol=2.5e-2)
    # another salt encodes other bits
    assert not torch.equal(enc.wait(enc.dispatch(8))[0], syms)
    with pytest.raises(ValueError, match="raw_input_hw=None"):
        bench.DeviceEncoder(_tiny_compressor(raw_input_hw=(96, 96)), 1, 1)


def test_compress_dataset_record_has_the_keys_on_a_cpu_stub():
    comp = _tiny_compressor(raw_input_hw=(96, 96))
    data = np.random.default_rng(0).integers(0, 256, (2, 4, 96, 96, 3),
                                             dtype=np.uint8)
    rec = bench.run_compress_dataset(
        comp, lambda: ((x, None) for x in data), 8, 2, data[0], 4,
        "stl10_encode_throughput_host_fed", "host_resident_uint8_96px")
    assert set(rec) == FED_KEYS and not set(rec) & TPU_KEYS
    assert rec["backend"] == "cpu" and rec["runs"] == 2


@pytest.mark.parametrize("mode", [[], ["--host-fed"], ["--folder-fed"]])
def test_main_refuses_to_run_without_a_card(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(mode)


def test_folder_fed_says_it_needs_pil(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="needs PIL"):
        bench.main_folder_fed(device="cpu")


@pytest.mark.parametrize("flags,knobs", [
    (["--softmax-dtype", "bfloat16"], {"softmax_dtype": "bfloat16"}),
    (["--host-fed", "--softmax-dtype", "bfloat16"],
     {"softmax_dtype": "bfloat16"}),
    ([], {})])
def test_main_knob_flags_reach_the_run_and_the_record(flags, knobs,
                                                      monkeypatch, capsys):
    """`--softmax-dtype` sets the attention knob for the run only and adds
    its key to the record; without it the record is the default line's."""
    from lossyless_tpu_torch.nn import flash_attn

    seen = {}

    def fake(device=None):
        seen.update(softmax=flash_attn.SOFTMAX_DTYPE)
        return {"value": 1.0}

    for name in ("main_device_resident", "main_host_fed"):
        monkeypatch.setattr(bench, name, fake)
    monkeypatch.setattr(bench, "card_line", lambda: "card")
    assert bench.main(flags) == 0
    record = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert record == {"value": 1.0, **knobs}
    assert seen["softmax"] == (torch.bfloat16 if "softmax_dtype" in knobs
                               else torch.float32)
    assert flash_attn.SOFTMAX_DTYPE == torch.float32
