"""`pipeline/hypopt.py` of the port against the JAX package.

Both searchers get the same stub `run_fn` (its metrics a function of the
config it is handed) and seed, with `prune` off and on: the sampled
parameters of every trial, every call the search makes (rungs and full
runs, with the fields a run depends on), the pruning decisions, the
`best` record and the written result are equal. The optuna branch runs
against a fake `optuna` module (JAX's `tests/test_aux_components.py`
double). Then one port-only search over the port's real `main` on a tiny
`banana_viz_VIC`: every trial runs a rung, and a surviving trial's full
run resumes from the rung's checkpoint, training only the epochs after
it.
"""

import json
import math
import sys
import types

import numpy as np
import pytest

from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.pipeline import hypopt as jhypopt   # the function
from lossyless_tpu_torch import pipeline as tpipeline
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import hypopt as thypopt
from lossyless_tpu_torch.pipeline import run as trun
from lossyless_tpu_torch.train import state as tstate

SPACE = {"loss.beta": ("log_uniform", 1e-3, 1.0),
         "encoder.z_dim": ("choice", [2, 4, 8]),
         "trainer.log_every": ("int", 1, 9),
         "optimizer_feat.lr": ("uniform", 1e-4, 1e-2)}


def _stub(calls: list):
    """A run_fn whose metrics follow the config (NaN for one z_dim, so the
    worst-value rule is exercised too)."""
    def run_fn(cfg):
        calls.append(dict(experiment=cfg.experiment, seed=cfg.trainer.seed,
                          rung=cfg.is_only_feat, skip=cfg.is_skip_comm,
                          epochs=cfg.data_feat.n_epochs,
                          out_dir=str(cfg.out_dir), beta=cfg.loss.beta,
                          z=cfg.encoder.z_dim))
        loss = math.log(cfg.loss.beta) * (1 + cfg.encoder.z_dim / 10) \
            + cfg.trainer.log_every / 7
        return {"test/feat/loss": -loss if cfg.is_only_feat else loss,
                "test/pred/loss": math.nan if cfg.encoder.z_dim == 8
                else loss, "tag": "not a number"}
    return run_fn


@pytest.fixture(autouse=True)
def _no_optuna(monkeypatch):
    monkeypatch.setitem(sys.modules, "optuna", None)


@pytest.mark.parametrize("prune", [False, True])
@pytest.mark.parametrize("direction", ["minimize", "maximize"])
def test_trials_match_jax_under_one_stub(prune, direction, tmp_path):
    ov = ["data_feat.n_epochs=8", f"out_dir={tmp_path}/o"]
    results, calls = {}, {}
    for name, cfgmod, search in (("jax", jconfig, jhypopt),
                                 ("port", tconfig, thypopt)):
        calls[name] = []
        base = cfgmod.apply_overrides(cfgmod.preset("banana_viz_VIC"), ov)
        results[name] = search(
            base, SPACE, monitor="test/pred/loss", n_trials=7,
            direction=direction, seed=3, run_fn=_stub(calls[name]),
            prune=prune, out_file=str(tmp_path / name / "r.json"))
    assert calls["port"] == calls["jax"]
    assert results["port"] == results["jax"]
    assert (tmp_path / "port" / "r.json").read_text() == \
        (tmp_path / "jax" / "r.json").read_text()
    trials = results["port"]["trials"]
    assert len(trials) == 7
    rungs = [c for c in calls["port"] if c["rung"]]
    if prune:
        assert len(rungs) == 7 and all(c["epochs"] == 2 and c["skip"]
                                       for c in rungs)
        assert any(t.get("pruned") for t in trials)
    else:
        assert not rungs
    assert any(t["value"] in (math.inf, -math.inf) for t in trials)


def _fake_optuna():
    """A fake `optuna` (JAX's `tests/test_aux_components.py` double): its
    study runs `n_trials` trials, prunes the odd ones when asked, and keeps
    the best. Returns the module and the list of studies it made."""
    class TrialPruned(Exception):
        pass

    class FakeTrial:
        def __init__(self, number, beta, prune_me):
            self.number, self._beta, self._prune_me = number, beta, prune_me
            self.reported, self.params, self.value = [], {}, None
            self.state = types.SimpleNamespace(name="RUNNING")

        def suggest_float(self, name, lo, hi, log=False):
            self.params[name] = self._beta
            return self._beta

        def report(self, value, step):
            self.reported.append((value, step))

        def should_prune(self):
            return self._prune_me

    class FakeStudy:
        def __init__(self, direction, pruner):
            self.direction, self.pruner = direction, pruner
            self.trials, self.best_value, self.best_params = [], None, None

        def optimize(self, objective, n_trials):
            for i in range(n_trials):
                t = FakeTrial(i, beta=0.1 * (i + 1), prune_me=i % 2 == 1)
                self.trials.append(t)
                try:
                    v = objective(t)
                except TrialPruned:
                    t.state.name = "PRUNED"
                    continue
                t.value, t.state.name = v, "COMPLETE"
                if self.best_value is None or v < self.best_value:
                    self.best_value = v
                    self.best_params = {"loss__beta": t._beta}

    studies = []

    def create_study(direction, pruner=None):
        studies.append(FakeStudy(direction, pruner))
        return studies[-1]

    fake = types.ModuleType("optuna")
    fake.TrialPruned = TrialPruned
    fake.create_study = create_study
    fake.pruners = types.SimpleNamespace(MedianPruner=lambda: "median")
    return fake, studies


def test_optuna_branch_against_a_fake_module(monkeypatch, tmp_path):
    """With optuna importable and prune=True, both packages' optuna branches
    run under the same fake module and the same `run_fn`: their calls, the
    values reported to the pruner, the pruned flags and the results are
    equal. A trial reports its rung value and is pruned when the pruner
    says so; the result keeps the built-in searcher's contract."""
    seen = {}
    for name, cfgmod, search in (("jax", jconfig, jhypopt),
                                 ("port", tconfig, thypopt)):
        fake, studies = _fake_optuna()
        monkeypatch.setitem(sys.modules, "optuna", fake)
        calls = []

        def fake_run(cfg, calls=calls):
            calls.append((cfg.is_only_feat, cfg.data_feat.n_epochs,
                          cfg.experiment, cfg.is_skip_comm,
                          str(cfg.out_dir), cfg.loss.beta))
            return {"test/feat/loss": cfg.loss.beta,
                    "val/feat/loss": cfg.loss.beta}

        res = search(cfgmod.preset("banana_viz_VIC"),
                     {"loss.beta": ("log_uniform", 1e-3, 1.0)},
                     monitor="val/feat/loss", n_trials=4, run_fn=fake_run,
                     prune=True, out_file=str(tmp_path / name / "r.json"))
        seen[name] = dict(
            calls=calls, result=res, pruner=studies[0].pruner,
            reported=[t.reported for t in studies[0].trials],
            file=(tmp_path / name / "r.json").read_text())
    assert seen["port"] == seen["jax"]
    calls, res = seen["port"]["calls"], seen["port"]["result"]
    rungs = [c for c in calls if c[0]]
    assert len(rungs) == 4 and all(c[1] == 25 and c[3] for c in rungs)
    assert [c[2] for c in calls if not c[0]] == \
        ["banana_viz_VIC_optuna0", "banana_viz_VIC_optuna2"]
    assert seen["port"]["pruner"] == "median"
    assert seen["port"]["reported"] == \
        [[(pytest.approx(0.1 * (i + 1)), 25)] for i in range(4)]
    assert [t["pruned"] for t in res["trials"]] == [False, True, False, True]
    assert res["best"] == {"params": {"loss.beta": 0.1}, "value": 0.1}
    assert res["direction"] == "minimize"


def test_rung_resume_over_the_real_main(tmp_path, monkeypatch):
    """Three trials of 4 epochs with pruning: each rung trains epoch 0 (4
    steps), each full run resumes there and trains epochs 1-3 (12 steps);
    the third trial's rung is pruned or resumed by the median rule."""
    base = tconfig.apply_overrides(tconfig.preset("banana_viz_VIC"), [
        "encoder.arch_kwargs.hid_dim=16", "distortion.arch_kwargs.hid_dim=16",
        "online.arch_kwargs.hid_dim=8", "data_feat.batch_size=64",
        "data_feat.val_batch_size=128", "data_feat.kwargs.length=256",
        "data_feat.n_epochs=4", "predictor.n_epochs=1",
        "predictor.arch_kwargs.hid_dim=16", "predictor.batch_size=64",
        f"out_dir={tmp_path}/out", f"ckpt_dir={tmp_path}/ckpt"])
    steps, calls = [0], []
    real_step = tstate.train_step

    def counting(*a, **k):
        steps[0] += 1
        return real_step(*a, **k)

    monkeypatch.setattr(tstate, "train_step", counting)
    monkeypatch.setattr(trun, "train_step", counting)

    def run_fn(cfg):
        steps[0] = 0
        metrics = trun.main(cfg, device="cpu")
        calls.append((cfg.experiment, cfg.is_only_feat, steps[0]))
        return metrics

    res = tpipeline.hypopt(base, {"loss.beta": ("log_uniform", 1e-3, 1.0)},
                           monitor="test/pred/loss", n_trials=3, seed=1,
                           run_fn=run_fn, prune=True,
                           out_file=str(tmp_path / "r.json"))
    rungs = [c for c in calls if c[1]]
    fulls = [c for c in calls if not c[1]]
    assert [c[0] for c in rungs] == [f"banana_viz_VIC_trial{t}"
                                     for t in range(3)]
    assert all(c[2] == 4 for c in rungs)
    assert len(fulls) >= 2 and all(c[2] == 12 for c in fulls)
    written = json.loads((tmp_path / "r.json").read_text())
    assert written["best"]["trial"] == res["best"]["trial"]
    assert np.isfinite(res["best"]["value"])
