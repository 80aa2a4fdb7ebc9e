"""Result aggregation: collect stage CSVs, summarize, RD curves, Pareto.

Counterpart of `lossyless_tpu/analysis/aggregate.py` over pandas and
matplotlib, reading the results CSVs through the port's
`train/metrics.py::read_results_csv`:

* `collect_data` globs `results/exp_*/**/results_*.csv` and parses the
  `name_value` path segments back into parameters.
* `merge_tables` joins featurizer/communication/predictor rows per run.
* `summarize_metrics` means/sems over seeds; `summarize_RD_curves` the
  area under each rate-distortion curve and the rates at the best
  distortions.
* `plot_rd_curves` / `plot_pareto_front` / `plot_scatter_lines` /
  `plot_invariance_RD_curve` / `plot_hypopt` render the trade-offs.

    python -m lossyless_tpu_torch.analysis.aggregate results/exp_x \
        --mode summarize rd_curves
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import pandas as pd

from ..train.metrics import read_results_csv

STAGES = ("featurizer", "communication", "predictor")

# pretty plot labels (reference utils/postplotting/pretty_renamer.py:5-38)
PRETTY_RENAMER = {
    "test/feat/rate": "Rate [bits]",
    "test/feat/distortion": "Distortion",
    "test/comm/n_bits": "Coded rate [bits]",
    "test/pred/acc": "Test accuracy",
    "test/pred/err": "Test error",
    "beta": r"$\beta$",
    "zdim": r"$\mathrm{dim}(Z)$",
    "dist_direct": "VIC/VAE",
    "dist_contrastive": "BINCE",
    "dist_lossy_Z": "Lossy $Z$",
    "rate_H_factorized": "Factorized prior",
    "rate_H_hyper": "Hyperprior",
    "rate_H_spatial": "Spatial hyperprior",
}


def prettify(name: str) -> str:
    return PRETTY_RENAMER.get(name, name.replace("_", " "))


def path_to_params(path: Path, base: Path) -> dict:
    """Parse `name_value` path segments into a params dict."""
    params = {}
    for seg in path.relative_to(base).parts[:-1]:
        if "_" in seg:
            name, value = seg.split("_", 1)
            try:
                params[name] = float(value) if _is_num(value) else value
            except ValueError:
                params[name] = value
    return params


def _is_num(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def collect_data(results_dir: str | Path,
                 pattern: str = "exp_*/**/results_*.csv") -> pd.DataFrame:
    base = Path(results_dir)
    rows = []
    for csv_path in sorted(base.glob(pattern)):
        stage = re.match(r"results_(\w+)\.csv", csv_path.name).group(1)
        row = dict(path_to_params(csv_path, base))
        row["stage"] = stage
        row["_dir"] = str(csv_path.parent)
        row.update(read_results_csv(csv_path))
        rows.append(row)
    return pd.DataFrame(rows)


def merge_tables(df: pd.DataFrame) -> pd.DataFrame:
    """One row per run, stage metrics side by side (aggregate.py:139-147)."""
    if df.empty:
        return df
    runs = []
    for run_dir, group in df.groupby("_dir"):
        merged = {}
        for _, row in group.iterrows():
            for k, v in row.items():
                if k in ("stage", "_dir"):
                    continue
                if isinstance(v, float) and math.isnan(v):
                    continue  # column absent in this stage's CSV
                merged[k] = v
        merged["_dir"] = run_dir
        runs.append(merged)
    return pd.DataFrame(runs)


def summarize_metrics(df: pd.DataFrame, group_by=None) -> pd.DataFrame:
    """Mean/SEM over seeds (aggregate.py:535)."""
    if df.empty:
        return df
    group_by = group_by or [c for c in ("exp", "datafeat", "dist", "enc",
                                        "rate", "zdim", "beta")
                            if c in df.columns]
    metric_cols = [c for c in df.columns
                   if df[c].dtype.kind in "fc" and c not in group_by]
    agg = df.groupby(group_by, dropna=False)[metric_cols].agg(["mean", "sem"])
    agg.columns = [f"{m}_{s}" for m, s in agg.columns]
    return agg.reset_index()


def melt_rate_distortions(df: pd.DataFrame, rate_col: str,
                          distortion_cols) -> pd.DataFrame:
    """Long format: one row per (run, distortion_type) with rate_val/
    distortion_val columns (reference merge_rate_distortions,
    aggregate.py:891-911)."""
    frames = []
    for dcol in distortion_cols:
        if dcol not in df.columns:
            continue
        sub = df.copy()
        sub["distortion_type"] = dcol
        sub["distortion_val"] = sub[dcol]
        sub["rate_val"] = sub[rate_col]
        frames.append(sub)
    if not frames:
        raise ValueError(f"none of {distortion_cols} present in the frame")
    return pd.concat(frames, ignore_index=True)


def _area_under_rd(group: pd.DataFrame) -> float:
    """Trapezoidal area under the RD curve (aggregate.py:914-917)."""
    g = group.sort_values("distortion_val")
    if len(g) < 2:
        return float("nan")
    return float(np.trapezoid(g["rate_val"].to_numpy(),
                              g["distortion_val"].to_numpy()))


def _rate_mindistortion(group: pd.DataFrame, min_distortion: float,
                        epsilon: float) -> tuple[float, float]:
    """Mean/sem rate over points epsilon-close to the minimal distortion
    (aggregate.py:920-947)."""
    close = group[group["distortion_val"] <= min_distortion + epsilon]
    return float(close["rate_val"].mean()), float(close["rate_val"].sem())


def summarize_RD_curves(
    df: pd.DataFrame,
    rate_col: str = "test/feat/rate",
    distortion_cols=("test/feat/distortion", "test/feat/online_loss"),
    mse_cols=("test/feat/distortion", "test/feat/online_loss"),
    sweep_col: str = "beta",
    agg_cols=("seed",),
    compare_cols=("dist",),
    epsilon_close_distortion: float = 0.01,
) -> pd.DataFrame:
    """Summaries of each RD curve (reference aggregate.py:437-533):

    * ``AURD`` — area under the rate-distortion curve swept over
      ``sweep_col`` (one curve per seed, then mean/sem over ``agg_cols``);
    * ``rate_mindist_curr`` — mean rate of points epsilon-close to that
      model's own best distortion;
    * ``rate_mindist_all`` — same, but epsilon-close to the best distortion
      across all models differing only in ``compare_cols``.

    MSE-valued distortions are first converted to differential-entropy upper
    bounds (0.5 * log2(2*pi*e*mse)) so rate and distortion share units.
    """
    df = df.copy()
    for c in mse_cols:
        if c in df.columns:
            df[c] = 0.5 * np.log2(2 * np.pi * np.e * df[c].astype(float))
    long = melt_rate_distortions(df, rate_col, distortion_cols)

    param_cols = [c for c in ("exp", "datafeat", "dist", "enc", "rate",
                              "zdim") if c in long.columns]
    curve_keys = param_cols + ["distortion_type"]          # one RD curve
    seed_keys = curve_keys + [c for c in agg_cols if c in long.columns]

    # AURD per seed-curve, then aggregated over seeds
    aurd = long.groupby(seed_keys, dropna=False).apply(
        _area_under_rd, include_groups=False).rename("AURD").reset_index()
    aurd = aurd.groupby(curve_keys, dropna=False)["AURD"] \
        .agg(["mean", "sem"]).rename(
            columns={"mean": "AURD_mean", "sem": "AURD_sem"})

    # best distortion across models differing only in compare_cols
    global_keys = [c for c in curve_keys if c not in compare_cols]
    global_min = long.groupby(global_keys, dropna=False)["distortion_val"] \
        .min().rename("global_min_distortion")

    rows = []
    for key, g in long.groupby(curve_keys, dropna=False):
        key = key if isinstance(key, tuple) else (key,)
        own_min = g["distortion_val"].min()
        cur_mean, cur_sem = _rate_mindistortion(
            g, own_min, epsilon_close_distortion)
        gkey = tuple(v for c, v in zip(curve_keys, key)
                     if c not in compare_cols)
        gmin = global_min.loc[gkey if len(gkey) > 1 else gkey[0]]
        all_mean, all_sem = _rate_mindistortion(
            g, float(gmin), epsilon_close_distortion)
        rows.append(dict(zip(curve_keys, key),
                         rate_mindist_curr_mean=cur_mean,
                         rate_mindist_curr_sem=cur_sem,
                         rate_mindist_all_mean=all_mean,
                         rate_mindist_all_sem=all_sem))
    mindist = pd.DataFrame(rows).set_index(curve_keys)
    return aurd.join(mindist).reset_index()


def kwargs_log_scale(values, base: float | None = None) -> dict:
    """Axis-scale kwargs for values that may include zero or negatives.

    Equivalent of the reference's `kwargs_log_scale`
    (utils/visualizations/helpers.py:21-77): plain log when every value is
    positive, symlog with a linear region sized by the smallest nonzero
    magnitude when zeros/negatives appear (beta sweeps start at 0), linear
    when the values are equally spaced or the auto-base degenerates to 1.
    The auto-base is the rounded mean ratio of consecutive positive values.
    Returns {"value": scale_name, **scale_kwargs} for `ax.set_xscale`.
    """
    v = np.asarray(sorted({float(u) for u in np.asarray(values).ravel()
                           if np.isfinite(u)}))
    pos = v[v > 0]
    if base is None:
        base = (int(np.round(np.mean(pos[1:] / pos[:-1])))
                if len(pos) > 1 else 10)
    d = np.diff(v)
    if base <= 1 or (len(d) > 1 and np.allclose(d, d[0])):
        return {"value": "linear"}
    if (v <= 0).any():
        nnz = v[v != 0]
        return {"value": "symlog", "base": base,
                "linthresh": float(np.abs(nnz).min()) if len(nnz) else 1.0,
                "linscale": 1.0 - 1.0 / base}
    return {"value": "log", "base": base}


def plot_scatter_lines(df: pd.DataFrame, out_path, x: str, y: str,
                       hue: str | None = None, kind: str = "line",
                       logbase_x: float | str | None = None,
                       logbase_y: float | str | None = None,
                       xlabel: str | None = None, ylabel: str | None = None,
                       is_errorbar: bool = False):
    """Generic scatter/line plot grouped by ``hue``
    (reference plot_scatter_lines, aggregate.py:619-716; the seaborn facet
    machinery is deliberately folded into one matplotlib axes)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    groups = df.groupby(hue, dropna=False) if hue and hue in df.columns \
        else [("all", df)]
    for name, g in groups:
        g = g.dropna(subset=[x, y]).sort_values(x)
        if g.empty:
            continue
        style = "o-" if kind == "line" else "o"
        if is_errorbar and f"{y}_sem" in g.columns:
            ax.errorbar(g[x], g[y], yerr=g[f"{y}_sem"], fmt=style,
                        capsize=3, label=str(name))
        else:
            ax.plot(g[x], g[y], style, label=str(name))
    # "auto" derives the base from the data; zero/negative values fall back
    # to symlog with a data-sized linear region (kwargs_log_scale)
    if logbase_x:
        kw = kwargs_log_scale(df[x].dropna().values,
                              base=None if logbase_x == "auto" else logbase_x)
        ax.set_xscale(kw.pop("value"), **kw)
    if logbase_y:
        kw = kwargs_log_scale(df[y].dropna().values,
                              base=None if logbase_y == "auto" else logbase_y)
        ax.set_yscale(kw.pop("value"), **kw)
    ax.set_xlabel(xlabel or prettify(x))
    ax.set_ylabel(ylabel or prettify(y))
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_invariance_RD_curve(
    df: pd.DataFrame, out_path,
    col_dist_param: str = "dist",
    noninvariant: str = "direct",
    rate_col: str = "test/feat/rate",
    upper_distortion: str = "test/feat/distortion",
    desirable_distortion: str = "test/feat/online_loss",
):
    """Invariance RD curves (reference plot_invariance_RD_curve,
    aggregate.py:364-434): every model is plotted against the *invariance*
    distortion H[M(X)|Z] (``desirable_distortion``); the non-invariant model
    additionally appears as 'Worst <model>' using its training distortion
    H[X|Z] (``upper_distortion``), a tight upper bound on the worst-case
    invariance distortion of an optimal non-invariant Z.
    """
    long = melt_rate_distortions(df, rate_col,
                                 [upper_distortion, desirable_distortion])
    keep = (long["distortion_type"] == desirable_distortion) | \
        (long[col_dist_param] == noninvariant)
    long = long[keep].copy()
    worst = (long[col_dist_param] == noninvariant) & \
        (long["distortion_type"] == upper_distortion)
    long.loc[worst, col_dist_param] = f"Worst {noninvariant}"
    return plot_scatter_lines(long, out_path, x="distortion_val",
                              y="rate_val", hue=col_dist_param,
                              xlabel="Distortion", ylabel="Rate (bits)")


def is_pareto_optimal(points: np.ndarray) -> np.ndarray:
    """Boolean mask of Pareto-optimal points, both axes minimized
    (aggregate.py:956)."""
    n = len(points)
    mask = np.ones(n, dtype=bool)
    for i in range(n):
        if not mask[i]:
            continue
        dominated = np.all(points <= points[i], axis=1) & \
            np.any(points < points[i], axis=1)
        if dominated.any():
            mask[i] = False
    return mask


def plot_rd_curves(df: pd.DataFrame, out_path, rate_col="test/feat/rate",
                   dist_col="test/feat/distortion", hue="dist"):
    """Rate-distortion curves grouped by `hue` (aggregate.py:243)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    groups = df.groupby(hue) if hue in df.columns else [("all", df)]
    for name, g in groups:
        g = g.sort_values(rate_col)
        ax.plot(g[rate_col], g[dist_col], "o-", label=str(name))
    ax.set_xlabel(prettify(rate_col))
    ax.set_ylabel(prettify(dist_col))
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_pareto_front(df: pd.DataFrame, out_path, rate_col="test/comm/n_bits",
                      err_col="test/pred/err"):
    """Rate vs downstream-error Pareto front (aggregate.py:302)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = df[[rate_col, err_col]].dropna().to_numpy()
    mask = is_pareto_optimal(pts)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.scatter(pts[~mask, 0], pts[~mask, 1], alpha=0.4, label="dominated")
    front = pts[mask][np.argsort(pts[mask, 0])]
    ax.plot(front[:, 0], front[:, 1], "ro-", label="pareto front")
    ax.set_xlabel(prettify(rate_col))
    ax.set_ylabel("Downstream error")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_hypopt(result: dict, out_path):
    """Trial values + best-so-far curve from a `pipeline.hypopt` result
    (the reference's optuna plots, aggregate.py:786)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    trials = result["trials"]
    values = [t["value"] for t in trials]
    acc = (np.maximum.accumulate
           if result.get("direction") == "maximize"
           else np.minimum.accumulate)
    best = acc(values)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(range(len(values)), values, "o", alpha=0.6, label="trials")
    ax.plot(range(len(values)), best, "r-", label="best so far")
    ax.set_xlabel("trial")
    ax.set_ylabel(prettify(result.get("monitor", "value")))
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


class ResultAggregator:
    """Facade mirroring the reference class (aggregate.py:114)."""

    def __init__(self, results_dir: str | Path):
        self.results_dir = Path(results_dir)
        self.df = merge_tables(collect_data(self.results_dir))

    def summarize(self, **kwargs) -> pd.DataFrame:
        out = summarize_metrics(self.df, **kwargs)
        path = self.results_dir / "summarized_metrics_merged.csv"
        out.to_csv(path, index=False)
        return out

    def rd_curves(self, **kwargs):
        return plot_rd_curves(self.df, self.results_dir / "rd_curves.png",
                              **kwargs)

    def summarize_rd_curves(self, **kwargs) -> pd.DataFrame:
        out = summarize_RD_curves(self.df, **kwargs)
        out.to_csv(self.results_dir / "summarized_RD_curves_merged.csv",
                   index=False)
        return out

    def invariance_rd_curve(self, **kwargs):
        return plot_invariance_RD_curve(
            self.df, self.results_dir / "invariance_RD_curve.png", **kwargs)

    def scatter_lines(self, x: str, y: str, filename: str | None = None,
                      **kwargs):
        name = filename or f"scatter_{x.replace('/', '_')}_" \
            f"{y.replace('/', '_')}.png"
        return plot_scatter_lines(self.df, self.results_dir / name, x=x, y=y,
                                  **kwargs)

    def pareto(self, **kwargs):
        return plot_pareto_front(self.df, self.results_dir / "pareto.png",
                                 **kwargs)


def main(argv=None) -> int:
    """Shell entry: aggregate results like the reference's bash scripts do
    (`python utils/aggregate.py` via hydra, bin/*/`*.sh` post-hoc calls).

        python -m lossyless_tpu_torch.analysis.aggregate results/exp_x \
            --mode summarize rd_curves
    """
    import argparse

    parser = argparse.ArgumentParser(
        prog="lossyless_tpu_torch.analysis.aggregate",
        description="aggregate results_*.csv under a results directory")
    parser.add_argument("results_dir")
    parser.add_argument("--mode", nargs="+", default=["summarize"],
                        choices=["summarize", "rd_curves", "summarize_rd",
                                 "invariance", "pareto", "all"],
                        help="which outputs to produce (csv/png written "
                             "next to the results)")
    args = parser.parse_args(argv)

    agg = ResultAggregator(args.results_dir)
    modes = set(args.mode)
    if "all" in modes:
        modes = {"summarize", "rd_curves", "summarize_rd", "invariance",
                 "pareto"}
    ran = []
    for mode, fn in (("summarize", agg.summarize),
                     ("rd_curves", agg.rd_curves),
                     ("summarize_rd", agg.summarize_rd_curves),
                     ("invariance", agg.invariance_rd_curve),
                     ("pareto", agg.pareto)):
        if mode in modes:
            try:
                out = fn()
                ran.append(mode)
                if hasattr(out, "to_string"):
                    print(f"[{mode}]")
                    print(out.to_string(index=False))
                else:
                    print(f"[{mode}] -> {out}")
            except (KeyError, ValueError) as e:
                # e.g. RD columns absent for a predictor-only experiment
                print(f"[{mode}] skipped: {e}")
    if not ran:
        return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
