"""The analysis suite of the port against the JAX package.

* aggregation: one results tree read by both packages' `collect_data`,
  then `merge_tables`, `summarize_metrics`, `melt_rate_distortions`,
  `summarize_RD_curves`, `path_to_params`, `is_pareto_optimal` and
  `kwargs_log_scale`, held equal with `pandas.testing.assert_frame_equal`;
  `main`'s modes, outputs and exit codes; every plot writes its file;
* the visualizations (reconstructions, traversals, the codebook, the
  max-invariant histogram, dataset samples), fed tensors too;
* `PretrainedAnalyser` over weights carried across from JAX's (a tiny
  `banana_viz_VIC` state saved by JAX, converted with
  `compressor_params_from_flax`, saved by the port): `featurize` and
  `decode` equal to JAX's analyser's at rtol 1e-5.
The cases of `tests/test_analysis.py` and `tests/test_aggregate_rd.py`
that have a port counterpart are mirrored here (the codecs' are in
`tests/test_torch_classical.py`).
"""

from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from pandas.testing import assert_frame_equal

from lossyless_tpu.analysis import aggregate as jagg
from lossyless_tpu.analysis import pretrained as jpre
from lossyless_tpu.compressors.compressor import LearnableCompressor as JLC
from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.pipeline import run as jrun
from lossyless_tpu.train import checkpoints as jckpt
from lossyless_tpu.train import state as jstate
from lossyless_tpu_torch.analysis import aggregate as tagg
from lossyless_tpu_torch.analysis import linear_eval as tlin
from lossyless_tpu_torch.analysis import pretrained as tpre
from lossyless_tpu_torch.analysis import visualize as tvis
from lossyless_tpu_torch.compressors import classical as tclassical
from lossyless_tpu_torch.compressors import compressor as tcomp
from lossyless_tpu_torch.data.banana import BananaDataset
from lossyless_tpu_torch.data.images import ImageDataset
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.train import checkpoints as tckpt
from lossyless_tpu_torch.train.metrics import write_results_csv
from tests import torch_threads  # noqa: F401  (one pool a worker)

# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------


def _tree(root: Path, stages=("featurizer", "communication", "predictor")):
    """A sweep of 2 seeds x 2 betas x 2 distortions in the pipeline's
    path scheme."""
    for dist in ("VIC", "BINCE"):
        for seed in (1, 2):
            for beta in ("1.0e-01", "3.0e-01"):
                d = (root / "exp_demo" / "datafeat_banana" / f"dist_{dist}"
                     / f"beta_{beta}" / f"seed_{seed}")
                b = float(beta)
                if "featurizer" in stages:
                    write_results_csv(d, "featurizer", {
                        "test/feat/rate": 5.0 + seed + b + len(dist),
                        "test/feat/distortion": 0.1 / b + 0.01 * seed,
                        "test/feat/online_loss": 0.2 + 0.01 * len(dist)})
                if "communication" in stages:
                    write_results_csv(d, "communication",
                                      {"test/comm/n_bits": 64.0 + 8 * b})
                if "predictor" in stages:
                    write_results_csv(d, "predictor", {
                        "test/pred/err": 0.02 * seed + 0.1 * b,
                        "test/pred/acc": 1 - 0.02 * seed - 0.1 * b})
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _tree(tmp_path_factory.mktemp("agg"))


def test_collect_merge_summarize_equal_jax(tree):
    jdf, tdf = jagg.collect_data(tree), tagg.collect_data(tree)
    assert len(tdf) == 24 and set(tdf["stage"]) == {
        "featurizer", "communication", "predictor"}
    assert_frame_equal(tdf, jdf)
    jm, tm = jagg.merge_tables(jdf), tagg.merge_tables(tdf)
    assert len(tm) == 8
    assert_frame_equal(tm, jm)
    for group_by in (None, ["datafeat", "dist"]):
        assert_frame_equal(tagg.summarize_metrics(tm, group_by=group_by),
                           jagg.summarize_metrics(jm, group_by=group_by))
    assert tagg.merge_tables(pd.DataFrame()).empty
    assert tagg.summarize_metrics(pd.DataFrame()).empty


def test_aggregator_roundtrip(tmp_path):
    """`tests/test_analysis.py::test_aggregator_roundtrip` on the port."""
    for seed in (1, 2):
        d = (tmp_path / "exp_demo" / "datafeat_banana" / "dist_VIC"
             / "beta_1.0e-01" / f"seed_{seed}")
        write_results_csv(d, "featurizer", {"test/feat/rate": 5.0 + seed,
                                            "test/feat/distortion": 0.1})
        write_results_csv(d, "predictor", {"test/pred/err": 0.02 * seed})
    df = tagg.collect_data(tmp_path)
    assert len(df) == 4 and (df["datafeat"] == "banana").all()
    merged = tagg.merge_tables(df)
    assert len(merged) == 2
    summary = tagg.summarize_metrics(merged, group_by=["datafeat", "dist"])
    assert summary["test/feat/rate_mean"].iloc[0] == pytest.approx(6.5)


def test_path_to_params_equal_jax(tmp_path):
    base = tmp_path
    for rel in ("exp_x/datafeat_mnist/beta_1.0e-01/seed_3/results_f.csv",
                "exp_x/enc_resnet18/zdim_128/noval/lr_abc/results_p.csv",
                "results_p.csv"):
        p = base / rel
        assert tagg.path_to_params(p, base) == jagg.path_to_params(p, base)
    assert tagg.path_to_params(
        base / "exp_x/zdim_128/beta_1.0e-01/r.csv", base) == {
        "exp": "x", "zdim": 128.0, "beta": 0.1}


@pytest.fixture()
def rd_frame():
    """`tests/test_aggregate_rd.py`'s sweep frame."""
    rows = []
    for exp, brd in {
        "vic": [(0.02, 8.0, 0.03), (0.07, 6.0, 0.06), (0.2, 4.0, 0.10)],
        "vae": [(0.02, 10.0, 0.05), (0.07, 9.0, 0.06), (0.2, 7.0, 0.11)],
    }.items():
        for seed in (1, 2):
            for beta, rate, dist in brd:
                rows.append({
                    "exp": exp, "datafeat": "banana", "dist": "direct",
                    "enc": "mlp", "rate": "H_factorized", "zdim": 2.0,
                    "beta": beta, "seed": seed,
                    "test/feat/rate": rate + 0.1 * seed,
                    "test/feat/distortion": dist,
                    "test/feat/online_loss": dist * 0.5})
    return pd.DataFrame(rows)


def test_summarize_rd_curves_equal_jax(rd_frame, tree):
    out = tagg.summarize_RD_curves(rd_frame, compare_cols=("exp",))
    assert_frame_equal(out, jagg.summarize_RD_curves(
        rd_frame, compare_cols=("exp",)))
    assert len(out) == 4 and (out["AURD_sem"] > 0).all()
    vic = out[(out.exp == "vic")
              & (out.distortion_type == "test/feat/distortion")].iloc[0]
    vae = out[(out.exp == "vae")
              & (out.distortion_type == "test/feat/distortion")].iloc[0]
    assert vic["rate_mindist_curr_mean"] == pytest.approx(8.15)
    assert vae["rate_mindist_curr_mean"] == pytest.approx(10.15)
    assert np.isnan(vae["rate_mindist_all_mean"])
    # the merged tree of the pipeline's path scheme
    merged = tagg.merge_tables(tagg.collect_data(tree))
    assert_frame_equal(tagg.summarize_RD_curves(merged),
                       jagg.summarize_RD_curves(merged))


def test_melt_rate_distortions_equal_jax(rd_frame):
    cols = ("test/feat/distortion", "test/feat/online_loss")
    long = tagg.melt_rate_distortions(rd_frame, "test/feat/rate", cols)
    assert len(long) == 2 * len(rd_frame)
    assert_frame_equal(long, jagg.melt_rate_distortions(
        rd_frame, "test/feat/rate", cols))
    for agg in (tagg, jagg):
        with pytest.raises(ValueError):
            agg.melt_rate_distortions(rd_frame, "test/feat/rate", ("nope",))


def test_pareto_and_log_scale_equal_jax():
    pts = np.array([[1, 5], [2, 3], [3, 4], [4, 1], [5, 2]])
    np.testing.assert_array_equal(tagg.is_pareto_optimal(pts),
                                  [True, True, False, True, False])
    rng = np.random.default_rng(0)
    cloud = rng.uniform(0, 1, (64, 2))
    np.testing.assert_array_equal(tagg.is_pareto_optimal(cloud),
                                  jagg.is_pareto_optimal(cloud))
    for values, base in (([0.01, 0.1, 1.0], None), ([0.0, 0.01, 0.1, 1.0],
                                                    None),
                         ([1, 2, 3, 4], 10), ([1.0, 1.1, 1.21], None),
                         ([-1.0, 0.5, 2.0, 8.0], 2), ([3.0], None)):
        assert tagg.kwargs_log_scale(values, base) == \
            jagg.kwargs_log_scale(values, base)
    assert tagg.kwargs_log_scale([0.01, 0.1, 1.0]) == {"value": "log",
                                                       "base": 10}


def test_plots_write_their_files(rd_frame, tree, tmp_path):
    files = [
        tagg.plot_scatter_lines(rd_frame, tmp_path / "s.png", x="beta",
                                y="test/feat/rate", hue="exp",
                                logbase_x=10),
        tagg.plot_scatter_lines(pd.DataFrame({"beta": [0.0, 0.01, 0.1, 1.0],
                                              "acc": [0.9, 0.8, 0.7, 0.6]}),
                                tmp_path / "sym.png", x="beta", y="acc",
                                logbase_x="auto"),
        tagg.plot_invariance_RD_curve(rd_frame, tmp_path / "inv.png",
                                      col_dist_param="exp",
                                      noninvariant="vae"),
        tagg.plot_rd_curves(rd_frame, tmp_path / "rd.png", hue="exp"),
        tagg.plot_hypopt({"trials": [{"value": v} for v in (3, 1, 2)],
                          "direction": "minimize",
                          "monitor": "test/pred/loss"}, tmp_path / "h.png")]
    merged = tagg.merge_tables(tagg.collect_data(tree))
    files.append(tagg.plot_pareto_front(merged, tmp_path / "p.png"))
    for f in files:
        assert Path(f).stat().st_size > 0


@pytest.mark.parametrize("modes", [["summarize"], ["rd_curves", "pareto"],
                                   ["summarize_rd", "invariance"], ["all"]])
def test_main_equals_jax(modes, tree, capsys):
    rc = {}
    out = {}
    for name, agg in (("jax", jagg), ("port", tagg)):
        rc[name] = agg.main([str(tree), "--mode", *modes])
        out[name] = capsys.readouterr().out
    assert rc["port"] == rc["jax"] == 0
    assert out["port"] == out["jax"]
    if "all" in modes:
        for f in ("summarized_metrics_merged.csv", "rd_curves.png",
                  "summarized_RD_curves_merged.csv", "invariance_RD_curve.png",
                  "pareto.png"):
            assert (tree / f).exists(), f


def test_main_exit_codes_equal_jax(tmp_path, capsys):
    """A predictor-only tree skips every RD output; an empty one too."""
    _tree(tmp_path / "pred", stages=("predictor",))
    (tmp_path / "empty").mkdir()
    for case, modes in (("pred", ["rd_curves", "summarize_rd", "pareto"]),
                        ("pred", ["summarize"]), ("empty", ["pareto"])):
        rcs, outs = [], []
        for agg in (jagg, tagg):
            rcs.append(agg.main([str(tmp_path / case), "--mode", *modes]))
            outs.append(capsys.readouterr().out)
        assert rcs[0] == rcs[1], (case, modes, outs)
        assert outs[0] == outs[1]
    with pytest.raises(SystemExit) as e:
        tagg.main([str(tmp_path), "--mode", "bogus"])
    assert e.value.code == 2


def test_result_aggregator_outputs(tree):
    agg = tagg.ResultAggregator(tree)
    assert_frame_equal(agg.df, jagg.ResultAggregator(tree).df)
    agg.summarize()
    agg.summarize_rd_curves()
    assert Path(agg.rd_curves()).exists()
    assert Path(agg.scatter_lines("beta", "test/feat/rate", hue="dist")
                ).exists()
    assert (tree / "summarized_metrics_merged.csv").exists()


def test_linear_eval_separable():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 400)
    z = rng.normal(0, 0.3, (400, 8)) + y[:, None] * 2.0
    res = tlin.z_linear_eval(z[:300], y[:300], z[300:], y[300:],
                             fixed_C=0.01)
    assert res["acc"] > 0.95


def test_ms_ssim_analytic_pin():
    """Constant images differing by a shift: MS-SSIM is the last scale's
    luminance term raised to the last weight."""
    x = np.full((1, 224, 224, 3), 0.5)
    y = np.full((1, 224, 224, 3), 0.6)
    c1 = 0.01 ** 2
    lum = (2 * 0.5 * 0.6 + c1) / (0.5 ** 2 + 0.6 ** 2 + c1)
    assert tclassical.ms_ssim(x, y) == pytest.approx(
        lum ** tclassical._MSSSIM_WEIGHTS[-1], rel=1e-9)
    assert tclassical.ms_ssim(x, x) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# Visualizations
# ---------------------------------------------------------------------------


def test_visualizations(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (8, 16, 16, 1))
    assert tvis.plot_reconstructions(
        torch.from_numpy(x), x + 0.01, tmp_path / "rec.png").exists()
    # a quantizer that rounds to a 1-unit grid, returning tensors
    tvis.codebook_plot(lambda p: torch.round(torch.from_numpy(p)),
                       lambda z: torch.from_numpy(z),
                       tmp_path / "codebook.png", n_grid=60)
    assert (tmp_path / "codebook.png").exists()
    ds = BananaDataset(length=2048)
    tvis.maxinv_distribution_plot(ds.data, ds.max_invariant,
                                  tmp_path / "maxinv.png")
    assert (tmp_path / "maxinv.png").exists()


def test_latent_traversals(tmp_path):
    """The latents each traversal hands the decoder, for both decoder
    kinds (images and 2-d points)."""
    seen = []

    def img_decode(zs):
        seen.append(np.asarray(zs))
        return torch.from_numpy(np.clip(
            zs[:, :1, None, None] * np.ones((1, 8, 8, 1)), 0, 1))

    z_dim = 6
    tvis.latent_traversal_1d(img_decode, z_dim, tmp_path / "t1.png",
                             n_per_lat=7, n_lat_traverse=3)
    zs, sweeps = seen[0], np.linspace(-5, 5, 7)
    assert zs.shape == (21, z_dim)
    for r in range(3):
        block = zs[r * 7:(r + 1) * 7]
        np.testing.assert_allclose(block[:, r], sweeps)
        np.testing.assert_array_equal(np.delete(block, r, axis=1), 0)
    seen.clear()
    tvis.latent_traversal_2d(img_decode, z_dim, tmp_path / "t2.png",
                             n_per_lat=5,
                             z_base=torch.full((z_dim,), 0.5))
    zs = seen[0]
    assert zs.shape == (25, z_dim)
    assert set(np.unique(zs[:, 0])) == set(np.linspace(-5, 5, 5))
    np.testing.assert_array_equal(zs[:, 2:], 0.5)

    def pt_decode(zs):
        return np.stack([zs[:, 0], np.sin(zs[:, 1])], -1)

    tvis.latent_traversal_1d(pt_decode, 2, tmp_path / "p1.png")
    tvis.latent_traversal_2d(pt_decode, 2, tmp_path / "p2.png")
    for f in ("t1", "t2", "p1", "p2"):
        assert (tmp_path / f"{f}.png").exists()
    with pytest.raises(ValueError):
        tvis.latent_traversal_2d(pt_decode, 1, tmp_path / "bad.png")


def test_plot_dataset_samples(tmp_path):
    arr = np.random.default_rng(0).uniform(0, 1, (10, 8, 8, 3))
    assert tvis.plot_dataset_samples(arr.astype(np.float32),
                                     tmp_path / "grid.png", n=4).exists()
    ds = ImageDataset("mnist", split="train", synthetic=True)
    assert tvis.plot_dataset_samples(ds, tmp_path / "grid_ds.png",
                                     n=4).exists()
    # fewer samples than n: it plots what there is
    ImageDataset._carve_fractions.clear()
    small = ImageDataset("mnist", split="train", synthetic=True,
                         synthetic_n=8, val_fraction=0.25)
    ImageDataset._carve_fractions.clear()
    assert tvis.plot_dataset_samples(small, tmp_path / "small.png",
                                     n=16).exists()


# ---------------------------------------------------------------------------
# PretrainedAnalyser over JAX's weights
# ---------------------------------------------------------------------------

BANANA = ["encoder.arch_kwargs.hid_dim=16", "distortion.arch_kwargs.hid_dim=16",
          "online.arch_kwargs.hid_dim=8", "data_feat.batch_size=64",
          "data_feat.kwargs.length=512"]


@pytest.fixture(scope="module")
def analysers(tmp_path_factory):
    """JAX's analyser and the port's over one tiny banana_viz_VIC state:
    JAX's weights saved by JAX, and converted and saved by the port."""
    tmp = tmp_path_factory.mktemp("analyser")
    ovs = BANANA + [f"out_dir={tmp}/out"]
    jcfg = jconfig.apply_overrides(jconfig.preset("banana_viz_VIC"),
                                   ovs + [f"ckpt_dir={tmp}/jax"])
    tcfg = tconfig.apply_overrides(tconfig.preset("banana_viz_VIC"),
                                   ovs + [f"ckpt_dir={tmp}/port"])
    ds = jrun.instantiate_datamodule(jcfg, jcfg.data_feat)
    sample = next(ds.batches(64, seed=jcfg.trainer.seed))
    state = jstate.TrainState.create(
        JLC(jcfg.compressor_config()), sample, jax.random.key(7),
        main=jstate.OptimConfig())
    params = jax.device_get(state.params)
    stats = jax.device_get(state.batch_stats)
    # move the BatchNorm statistics off their initial values
    stats = jax.tree.map(lambda a: np.asarray(a) + np.float32(0.25), stats)
    jckpt.save_weights(Path(jcfg.ckpt_dir) / jcfg.long_name
                       / "best_featurizer", params, stats)
    tckpt.save_weights(Path(tcfg.ckpt_dir) / tcfg.long_name
                       / "best_featurizer",
                       tcomp.compressor_params_from_flax(
                           jax.tree.map(np.asarray, params),
                           jax.tree.map(np.asarray, stats)))
    return (jpre.PretrainedAnalyser(jcfg),
            tpre.PretrainedAnalyser(tcfg, device="cpu"))


def test_pretrained_analyser_equals_jax(analysers):
    jan, tan = analysers
    pts = np.random.default_rng(3).normal(0, 2, (256, 2)).astype(np.float32)
    want = np.asarray(jan.featurize(pts))
    got = tan.featurize(pts)
    assert got.device.type == "cpu" and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    z = np.random.default_rng(4).normal(0, 3, (64, 2)).astype(np.float32)
    np.testing.assert_allclose(tan.decode(z), jan.decode(z), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tan.decode(want), jan.decode(want),
                               rtol=1e-5, atol=1e-6)
    assert not tan.model.training


def test_pretrained_analyser_plots(analysers, tmp_path):
    _, tan = analysers
    assert Path(tan.codebook_plot(tmp_path / "cb.png", n_grid=40)).exists()
    p1, p2 = tan.latent_traversal_plot(tmp_path / "trav", n_per_lat=5)
    assert Path(p1).exists() and Path(p2).exists()
    assert Path(tan.maxinv_distribution_plot(tmp_path / "mi.png",
                                             n_samples=500)).exists()


def test_pretrained_analyser_missing_weights(tmp_path):
    cfg = tconfig.apply_overrides(tconfig.preset("banana_viz_VIC"), BANANA + [
        f"ckpt_dir={tmp_path}"])
    with pytest.raises(FileNotFoundError):
        tpre.PretrainedAnalyser(cfg, device="cpu")
