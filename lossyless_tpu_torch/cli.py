"""Experiment CLI: `python -m lossyless_tpu_torch.cli <preset> [overrides]`.

Counterpart of `lossyless_tpu/cli.py`: pick a preset experiment, apply
dotted overrides, run the three-stage pipeline (`pipeline.run.main`) and
print its metrics as JSON. It runs on the card unless `--device` names
another device.

Example:
    python -m lossyless_tpu_torch.cli banana_viz_VIC loss.beta=0.07 \\
        data_feat.n_epochs=50 trainer.seed=123

    # a beta sweep, one pipeline a value
    python -m lossyless_tpu_torch.cli banana_RD -m loss.beta=0.01,0.1,1

Modes: `--dev` caps the epochs at 2 and the batches at 10% (train) and
20% (eval); `--debug` one epoch on 1% of the batches, with autograd's
anomaly detection on (`core.profiling.debug_mode`: it raises at the op
that made a NaN); `--overfit` 10% of the batches; `--profile-dir D`
traces the run with torch.profiler into `D/trace.json` (under `-m`, job
i into `D/job{i}/trace.json`). `--classical MODE` (jpeg, webp, png,
identity) trains nothing: it codes the test split of `data_feat`, built
on the CLI's device, with a classical codec on the host and writes the
featurizer results CSV under `<experiment>_classical_<MODE>`; it refuses
`-m`.

Data parallelism: `trainer.n_devices=N` trains over N ranks, spawned by
the pipeline (one a card, or N gloo processes with `--device cpu`); under
torchrun (`torchrun --nproc-per-node N -m lossyless_tpu_torch.cli ...
trainer.n_devices=N`) each process joins the group torchrun describes
before anything touches a device, and only rank 0 prints.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json


def _parser(presets: list[str]) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="presets: " + ", ".join(presets))
    parser.add_argument("preset",
                        help="experiment preset name (see list below) or "
                             "'default'")
    parser.add_argument("overrides", nargs="*",
                        help="dotted overrides key=value")
    parser.add_argument("--dev", action="store_true",
                        help="dev mode: cap epochs and batches")
    parser.add_argument("--debug", action="store_true",
                        help="debug mode: one epoch on 1%% of the batches, "
                             "autograd anomaly detection on")
    parser.add_argument("--overfit", action="store_true",
                        help="overfit mode: train and eval on 10%% of "
                             "batches")
    parser.add_argument("--profile-dir", default=None,
                        help="trace the run with torch.profiler into this "
                             "directory (a Chrome trace)")
    parser.add_argument("--classical", default=None,
                        choices=["jpeg", "webp", "png", "identity"],
                        help="evaluate a classical codec baseline "
                             "instead of training")
    parser.add_argument("-m", "--multirun", action="store_true",
                        help="comma-separated override values expand into "
                             "a cartesian sweep (e.g. -m "
                             "loss.beta=0.01,0.1,1)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    return parser


def main(argv=None):
    from .core.mesh import init_distributed, rank_world
    from .pipeline.config import (ExperimentConfig, apply_overrides,
                                  available_presets, preset)

    # options may come between the overrides (`banana_RD -m --dev a=1 b=2`)
    args = _parser(available_presets()).parse_intermixed_args(argv)
    # torchrun's group (a no-op without its environment), before any use
    # of a device
    init_distributed(args.device)

    cfg = (ExperimentConfig() if args.preset == "default"
           else preset(args.preset))
    if args.dev:
        cfg.data_feat.n_epochs = min(cfg.data_feat.n_epochs, 2)
        cfg.trainer.limit_train_batches = 0.1
        cfg.trainer.limit_eval_batches = 0.2
    if args.debug:
        cfg.data_feat.n_epochs = 1
        cfg.trainer.limit_train_batches = 0.01
        cfg.trainer.limit_eval_batches = 0.01
    if args.overfit:
        cfg.trainer.limit_train_batches = 0.1
        cfg.trainer.limit_eval_batches = 0.1

    if args.multirun:
        if args.classical:
            raise SystemExit(
                "--classical is not supported with -m/--multirun; run the "
                "classical baseline per configuration instead")
        return _multirun(cfg, args)

    cfg = apply_overrides(cfg, args.overrides)
    if args.classical:
        metrics = _classical(cfg, args.classical, args.device)
    else:
        metrics = _run(cfg, args, args.profile_dir)
    if rank_world()[0] == 0:
        print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in metrics.items()}, indent=2))
    return metrics


def _run(cfg, args, profile_dir=None) -> dict:
    """The pipeline under `--debug`'s anomaly detection and, with a
    `profile_dir`, a torch.profiler trace into it."""
    from .core.profiling import debug_mode, profile_trace
    from .pipeline.run import main as run_main

    with debug_mode(args.debug), profile_trace(profile_dir):
        return run_main(cfg, device=args.device)


def _classical(cfg, mode: str, device=None) -> dict:
    """The test split of `data_feat` (all of it, in `_all_batches` order,
    the ragged tail kept) through a classical codec; writes the
    featurizer results CSV under `<experiment>_classical_<mode>`."""
    from .compressors.classical import ClassicalCompressor
    from .pipeline.run import (_all_batches, _test_dataset,
                               instantiate_datamodule)
    from .train.metrics import write_results_csv

    instantiate_datamodule(cfg, cfg.data_feat, device=device)
    ds = _test_dataset(cfg, cfg.data_feat, device)
    bs = min(cfg.data_feat.val_batch_size, len(ds))
    metrics = ClassicalCompressor(mode=mode).evaluate(
        _all_batches(ds, bs, cfg.trainer.seed), stage="feat")
    cfg.experiment = f"{cfg.experiment}_classical_{mode}"
    write_results_csv(cfg.stage_dir, "featurizer", metrics)
    return metrics


def _multirun(base_cfg, args) -> list[dict]:
    """Comma lists expand to a cartesian sweep, one pipeline a combination.

    Result paths are told apart by the swept values (beta, seed, z_dim,
    ... are in the `long_name` path); a `-run{i}` experiment suffix is
    added only when a combination's path is already taken, so the
    aggregator's path parsing keeps working.
    """
    from .pipeline.config import apply_overrides

    sweeps, fixed = [], []
    for ov in args.overrides:
        key, value = ov.split("=", 1)
        if "," in value and not value.lstrip().startswith(("(", "[", "{")):
            sweeps.append((key, value.split(",")))
        else:
            fixed.append(ov)
    if not sweeps:
        sweeps = [("", [""])]  # one job

    results = []
    seen_names = set()
    for i, combo in enumerate(itertools.product(*(v for _, v in sweeps))):
        ovs = list(fixed) + [f"{k}={v}" for (k, _), v in zip(sweeps, combo)
                             if k]
        cfg = apply_overrides(copy.deepcopy(base_cfg), ovs)
        if cfg.long_name in seen_names:
            cfg.experiment = f"{cfg.experiment}-run{i}"
        seen_names.add(cfg.long_name)
        # each job traces into a directory of its own
        pdir = f"{args.profile_dir}/job{i}" if args.profile_dir else None
        metrics = _run(cfg, args, pdir)
        rec = {"job": i, "overrides": ovs,
               "metrics": {k: v for k, v in metrics.items()
                           if isinstance(v, (int, float))}}
        print(json.dumps(rec))
        results.append(rec)
    return results


if __name__ == "__main__":
    main()
