"""Port training I/O against the JAX package: metrics, CSVs, loggers,
stage sentinels and the weights export's tmp/old swap.

The metrics and CSV files must be the JAX package's byte for byte, from
the same logs. The swap cases are tests/test_resume.py's that apply to a
single-file `torch.save` export (the orbax `CheckpointManager` is not
ported): every crash window of the two-rename swap resolves to a complete
file, and a bare `.tmp` is not a checkpoint, as in JAX.
"""

import math
import shutil
import sys

import numpy as np
import pytest
import torch

from lossyless_tpu.train import checkpoints as jckpt
from lossyless_tpu.train import loggers as jloggers
from lossyless_tpu.train import metrics as jmetrics
from lossyless_tpu_torch.train import checkpoints as tckpt
from lossyless_tpu_torch.train import loggers as tloggers
from lossyless_tpu_torch.train import metrics as tmetrics
from tests import torch_threads  # noqa: F401  (one pool a worker)

LOG_ROWS = [
    {"loss": 1.5, "rate": np.float32(3.25), "flag": True},
    {"loss": torch.tensor(1.25), "name": "skip-me", "vec": np.ones(3)},
    {"loss": 1.0, "rate": 2.0, "val/feat/loss": 0.5},   # a new column
    {"loss": float("nan"), "rate": math.inf, "distortion": 0.125},
]


def _plain(row):
    """The row as JAX sees it (no torch tensors)."""
    return {k: float(v) if isinstance(v, torch.Tensor) else v
            for k, v in row.items()}


def test_accumulator_means_match_jax():
    j, t = jmetrics.MetricAccumulator(), tmetrics.MetricAccumulator()
    for i, row in enumerate(LOG_ROWS):
        j.update(_plain(row), weight=i + 1)
        t.update(row, weight=i + 1)
    assert t.means() == j.means()
    assert "name" not in t.means() and "vec" not in t.means()
    t.reset()
    assert t.means() == {}


def test_namespaced_and_results_csv_match_jax(tmp_path):
    metrics = {"n_bits": 1234.5, "encoder_time": 1e-4, "bpp": 0.0246,
               "git_hash": "abc123"}
    ns = tmetrics.namespaced(metrics, "test", "comm")
    assert ns == jmetrics.namespaced(metrics, "test", "comm")
    jp = jmetrics.write_results_csv(tmp_path / "jax", "communication", ns)
    tp = tmetrics.write_results_csv(tmp_path / "torch", "communication", ns)
    assert tp.name == jp.name == "results_communication.csv"
    assert tp.read_bytes() == jp.read_bytes()
    assert tmetrics.read_results_csv(tp) == jmetrics.read_results_csv(jp) \
        == ns


@pytest.mark.parametrize("resume", [False, True])
def test_csv_logger_files_match_jax(tmp_path, resume):
    """Header growth on a new key and header adoption on resume give the
    same file as JAX's logger."""
    files = {}
    for name, mod, conv in (("jax", jmetrics, _plain),
                            ("torch", tmetrics, lambda r: r)):
        out = tmp_path / name
        lg = mod.CsvLogger(out, "train_featurizer")
        for step, row in enumerate(LOG_ROWS[:3]):
            lg.log(step, conv(row))
        if resume:   # a new logger over the same file, as after preemption
            lg = mod.CsvLogger(out, "train_featurizer")
        lg.log(3, conv(LOG_ROWS[3]))
        files[name] = (out / "train_featurizer.csv").read_bytes()
    assert files["torch"] == files["jax"]
    assert b"val/feat/loss" in files["torch"].splitlines()[0]


@pytest.mark.parametrize("mode,cls", [("csv", "CsvTrainLogger"),
                                      ("none", "NoLogger"),
                                      (None, "NoLogger")])
def test_get_logger_modes(tmp_path, mode, cls):
    lg = tloggers.get_logger(mode, tmp_path, name="train_featurizer")
    assert type(lg).__name__ == cls == type(jloggers.get_logger(
        mode, tmp_path / "j", name="train_featurizer")).__name__
    lg.log(1, {"loss": torch.tensor(0.5)})
    lg.finish()
    assert (tmp_path / "train_featurizer.csv").exists() == (mode == "csv")


def test_wandb_without_wandb_raises(tmp_path, monkeypatch):
    """JAX writes CSV in wandb's place; the port refuses instead."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(RuntimeError, match="wandb is not installed"):
        tloggers.get_logger("wandb", tmp_path)
    with pytest.raises(ValueError, match="unknown logger"):
        tloggers.get_logger("tensorboard", tmp_path)


@pytest.mark.parametrize("stage", ["featurizer", "communication",
                                   "predictor"])
def test_stage_sentinels_match_jax(tmp_path, stage):
    t, j = tmp_path / "t", tmp_path / "j"
    assert tckpt.stage_sentinel(t, stage).name == \
        jckpt.stage_sentinel(j, stage).name
    assert not tckpt.is_stage_done(t, stage)
    tckpt.mark_stage_done(t, stage)
    jckpt.mark_stage_done(j, stage)
    assert tckpt.is_stage_done(t, stage) and jckpt.is_stage_done(t, stage)
    assert tckpt.stage_sentinel(t, stage).read_bytes() == \
        jckpt.stage_sentinel(j, stage).read_bytes()


# ---------------------------------------------------------------------------
# save_weights / load_weights and the swap's crash windows
# ---------------------------------------------------------------------------


def _weights(fill=0.0):
    return {"dense.kernel": torch.arange(6.0).reshape(2, 3) + fill,
            "dense.bias": torch.full((3,), 7.0 + fill)}


def _assert_weights(got, want):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def _saved(tmp_path, fill=0.0):
    path = tmp_path / "best_featurizer"
    tckpt.save_weights(path, _weights(fill))
    return path


def _sibling(path, suffix):
    return path.with_name(path.name + suffix)


def test_save_and_load_round_trip(tmp_path):
    path = _saved(tmp_path)
    _assert_weights(tckpt.load_weights(path), _weights())
    tckpt.save_weights(path, _weights(1.0))      # overwrite through a swap
    _assert_weights(tckpt.load_weights(path), _weights(1.0))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["best_featurizer"]


def test_mid_swap_window_resolves_to_tmp_and_heals(tmp_path):
    """No file, complete `.tmp` and `.old`: the window between the two
    renames. The newest (`.tmp`) wins and the swap is finished."""
    path = _saved(tmp_path, 1.0)
    shutil.copy(path, _sibling(path, ".tmp"))
    old = _saved(tmp_path / "o", 0.0)
    shutil.move(old, _sibling(path, ".old"))
    path.unlink()
    assert tckpt.resolve_swap(path) == path
    assert not _sibling(path, ".tmp").exists()
    assert not _sibling(path, ".old").exists()
    _assert_weights(tckpt.load_weights(path), _weights(1.0))


def test_old_alone_resolves(tmp_path):
    path = _saved(tmp_path)
    path.rename(_sibling(path, ".old"))
    _assert_weights(tckpt.load_weights(path), _weights())
    assert path.exists() and not _sibling(path, ".old").exists()


def test_partial_tmp_with_old_falls_back_to_old(tmp_path):
    """A second preemption mid-save: a truncated `.tmp` must not shadow
    the complete `.old`."""
    path = _saved(tmp_path)
    data = path.read_bytes()
    path.rename(_sibling(path, ".old"))
    _sibling(path, ".tmp").write_bytes(data[: len(data) // 2])
    _assert_weights(tckpt.load_weights(path), _weights())
    assert not _sibling(path, ".tmp").exists()


@pytest.mark.parametrize("complete", [True, False])
def test_bare_tmp_is_not_a_checkpoint(tmp_path, complete):
    """A `.tmp` with neither the file nor `.old` is a first save that died
    before its swap: not resolved, as JAX's `resolve_swap` (a complete one
    too, the JAX-side behaviour kept for parity)."""
    path = _saved(tmp_path)
    data = path.read_bytes()
    path.unlink()
    _sibling(path, ".tmp").write_bytes(data if complete
                                       else data[: len(data) // 3])
    assert tckpt.resolve_swap(path) is None
    with pytest.raises(FileNotFoundError, match="no weights"):
        tckpt.load_weights(path)
    # the JAX function on the same layout (a directory there)
    jpath = tmp_path / "jax_ckpt"
    (tmp_path / "jax_ckpt.tmp").mkdir()
    assert jckpt.resolve_swap(jpath) is None


def test_save_heals_pending_window_first(tmp_path):
    """Saving over a swap window must not destroy the newest complete
    file: it heals, then swaps as usual."""
    path = _saved(tmp_path, 1.0)
    shutil.copy(path, _sibling(path, ".tmp"))
    path.rename(_sibling(path, ".old"))
    tckpt.save_weights(path, _weights(2.0))
    _assert_weights(tckpt.load_weights(path), _weights(2.0))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["best_featurizer"]


def test_save_never_deletes_before_swap(tmp_path, monkeypatch):
    """A crash during the write of `.tmp` leaves the previous export
    whole and loadable."""
    path = _saved(tmp_path)

    def crash(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"PK\x03\x04 partial")
        raise OSError("preempted")

    monkeypatch.setattr(tckpt.torch, "save", crash)
    with pytest.raises(OSError, match="preempted"):
        tckpt.save_weights(path, _weights(5.0))
    monkeypatch.undo()
    _assert_weights(tckpt.load_weights(path), _weights())
