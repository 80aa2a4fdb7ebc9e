"""Fixtures of the benchmark's tests: a checkout root and a benchmark
directory holding the cells at a size the CPU runs in seconds (the tower
at width 64 and 2 blocks, ResNet-18 on 32 px images at batch 8)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (run on the chip)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _edit(path: Path, fn):
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))


@pytest.fixture
def tiny(tmp_path) -> tuple[Path, Path]:
    """(root, bench_dir): BENCHMARK.json as committed, the configurations
    and mixes cut to CPU size, the limits and the metric readers as
    committed."""
    root, bench = tmp_path, tmp_path / "benchmark"
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(BENCH / sub, bench / sub)
    _edit(bench / "configs" / "clip_vitb32_hub.json",
          lambda c: c["tower"].update(width=64, layers=2, heads=2))
    for mix in ("stl10_96", "imagenet_256"):
        _edit(bench / "traffic" / f"{mix}.json",
              lambda t: t.update(images=70, batch=32, check_images=40))
    _edit(bench / "configs" / "stl10_bince.json",
          lambda c: c["overrides"].extend(["data_feat.batch_size=8",
                                           "trainer.precision=fp32"]))
    _edit(bench / "traffic" / "bince_stl10.json",
          lambda t: t.update(dataset="cifar10", images=48, slice=[2, 2]))
    return root, bench
