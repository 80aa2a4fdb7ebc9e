"""Everything the harness runs, found by name.

`BENCHMARK.json` at the root of the checkout names the cells, the
metrics and their bounds. A cell names a configuration
(`benchmark/configs/<config>.json`) and a traffic mix
(`benchmark/traffic/<traffic>.json`); the mix names the driver that runs
it (`benchmark/drivers/<driver>.py`); the limits of the cell's check are
`benchmark/limits/<cell>.json`, set for that cell alone. A per-layer
metric is read by `benchmark/metrics/<metric name>.py`, or, where there
is none, by the reader of the name before its first dot (`x.train` and
`x.encode` share `x.py`). Adding a cell, a configuration, a mix or a
metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict          # the check's limits, by the number's name
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_benchmark(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str, bench_dir: Path = HERE) -> Cell:
    bench = load_benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    with open(bench_dir / "configs" / f"{w['config']}.json") as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(bench_dir / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config,
                traffic, limits, e2e, per_layer)


def driver(cell: Cell):
    """The driver module that runs the cell's traffic."""
    kind = cell.traffic["driver"]
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_path(name: str, bench_dir: Path = HERE) -> Path:
    """The reader's file of the per-layer metric `name`."""
    path = bench_dir / "metrics" / f"{name}.py"
    if not path.is_file():
        path = bench_dir / "metrics" / f"{name.split('.', 1)[0]}.py"
    return path


def metric_reader(name: str, bench_dir: Path = HERE):
    """`read(record) -> float | None` of the per-layer metric `name`."""
    path = metric_path(name, bench_dir)
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '__')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Record:
    """What a per-layer metric reads: the cell, the end-to-end values of
    the window, the reduced profiler slice (`trace.Slice`) and what the
    driver counted (`info`: shapes, batches or steps in the slice)."""

    cell: Cell
    window: dict
    slice: object
    info: dict
