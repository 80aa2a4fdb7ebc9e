"""The plain reference against the program at a small size on the CPU,
and the controls in a lower precision failing the comparison."""

import numpy as np
import pytest
import torch

from benchmark import cells, seeded
from benchmark.drivers import encode, train
from benchmark.reference import coding
from benchmark.reference import vit as ref_vit


def test_tables_equal_the_programs_and_decode_its_streams():
    from lossyless_tpu_torch.coding import entropy_bottleneck as eb
    from lossyless_tpu_torch.coding.rans import RansCodec

    prior = seeded.factorized_prior(64, (3, 3, 3), 10.0,
                                    seeded.generator(3, "cpu"), "cpu")
    t = eb.build_cdf_tables(prior, arithmetic="compressai")
    cdfs, offsets, med = coding.cdf_tables(prior)
    for c in range(64):
        assert np.array_equal(t.quantized_cdf[c, :t.cdf_length[c]], cdfs[c])
    assert np.array_equal(t.offset, offsets)
    assert np.array_equal(prior["quantiles"][:, 0, 1], med)
    sym = np.round(np.random.default_rng(0).normal(0, 4, (50, 64))
                   ).astype(np.int32)
    sym[0, 0], sym[1, 5], sym[2, 7] = 40, -35, 1000    # escapes
    streams = RansCodec(t.quantized_cdf, t.cdf_length, t.offset) \
        .encode_batch(sym, np.arange(64))
    dec, bad = coding.decode(streams, cdfs, offsets)
    assert not bad.any() and np.array_equal(dec, sym)
    broken = list(streams)
    broken[3] = broken[3][:-4]
    broken[4] = broken[4][:8] + bytes([broken[4][8] ^ 1]) + broken[4][9:]
    _, bad = coding.decode(broken, cdfs, offsets)
    assert list(np.nonzero(bad)[0]) == [3, 4]


@pytest.mark.parametrize("hw", [(96, 96), (256, 256), (100, 130)])
def test_preprocess_matches_the_programs(hw):
    from lossyless_tpu_torch.nn.vit import clip_preprocess

    x = torch.randint(0, 256, (2, *hw, 3), dtype=torch.uint8)
    got = ref_vit.preprocess(x)
    assert torch.allclose(got, clip_preprocess(x.float() / 255), atol=2e-4)


def test_tower_matches_the_programs_in_float32():
    from lossyless_tpu_torch.nn.vit import VisionTransformer

    shapes = ref_vit.weight_shapes(64, 2, 32, 224, 512)
    w = seeded.tower_weights(shapes, seeded.generator(1, "cpu"), "cpu",
                             torch.float32)
    m = VisionTransformer(width=64, layers=2, heads=2, dtype=torch.float32)
    m.load_state_dict(w)
    x = ref_vit.preprocess(torch.randint(0, 256, (3, 96, 96, 3),
                                         dtype=torch.uint8))
    with torch.no_grad():
        assert torch.allclose(ref_vit.Tower(w, 2)(x), m(x), atol=1e-5)


def _session(tiny, name, seed=11):
    root, bench = tiny
    cell = cells.load_cell(root, name, bench)
    s = cells.driver(cell).Session(cell, seed, "cpu")
    return cell, s


def test_encode_passes_and_its_fp8_control_fails(tiny):
    cell, s = _session(tiny, "vitb32.encode_stl10")
    s.setup()
    s.window(0.0)
    s.closing()
    s.free()
    checks = s.check()
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    control = s.control()
    assert any(control[k] > cell.limits[k] for k in control), control


def test_bince_reference_follows_the_program(tiny):
    from benchmark.reference import bince as ref_bince

    cell, s = _session(tiny, "bince.train")
    s.setup()
    s.window(0.0)
    s.closing()
    s.free()
    assert s.late["start"]["step"] == 2 * s.steps_per_epoch
    for st in (s.first, s.late):   # each epoch's step 1, to rounding
        got = s.program_readings(st)
        ref = ref_bince.follow(st["params0"], s._batches(st), s._hp(),
                               "fp32", n_steps=1, start=st["start"])
        for k in ("loss", "rate", "distortion"):
            assert got["logs"][0][k] == pytest.approx(ref["logs"][0][k],
                                                      rel=1e-5)
    checks = s.check()
    assert set(checks) == set(cell.limits)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
    control = s.control()
    assert any(control[k] > cell.limits[k] for k in control), control


def test_compare_reads_a_wholly_wrong_image():
    ref = np.zeros((4, 8), np.int64)
    got = ref.copy()
    got[2] += 1
    numbers = encode.compare(got, ref, np.zeros(4, bool))
    assert numbers == {"flip_share": 0.25, "worst_image_flip_share": 1.0}
    bad = np.array([False, True, False, False])
    assert encode.compare(ref, ref, bad)["worst_image_flip_share"] == 1.0


def test_training_compare_by_the_worst_leaf():
    e = "rate_estimator.entropy_bottleneck."
    init = {k: torch.zeros(3) for k in ("a", "c", "d", "b", e + "matrix0",
                                         e + "bias0")}
    ref = {"logs": [{"loss": 2.0, "rate": 1.0, "distortion": 1.0}] * 3,
           "grad": {"a": torch.ones(3), "c": torch.ones(3),
                    "d": torch.ones(3), "b": torch.full((3,), 1e-9),
                    e + "matrix0": torch.full((3,), 1e-7),
                    e + "bias0": torch.full((3,), 1e-7)},
           "params": {k: torch.ones(3) for k in init}}
    same = train.compare(ref, ref, init)
    assert all(v == 0 for v in same.values())
    unchanged = dict(ref, params=init)
    # "b"'s and the rate's gradients are under a thousandth of the median
    # leaf's: they are left out of the change, "a" reads 1
    assert train.compare(unchanged, ref, init)["change_norm_gap"] == 1.0
    # the rate's leaves are held against their own median: a rate leaf
    # with no gradient reads 1 there, and next to nothing against all
    no_rate = dict(ref, grad=dict(ref["grad"], **{e + "bias0":
                                                   torch.zeros(3)}))
    numbers = train.compare(no_rate, ref, init)
    assert numbers["rate_grad_gap"] == 1.0
    assert numbers["grad_norm_gap"] < 1e-6
