"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout: set up the cell (the program built or
loaded from its cache, weights and inputs made from the seed, the cell's
shapes warmed), measure for `--seconds`, then, with `--trace 1`, profile
a bounded slice; read the memory peak, run what the check follows after
the window (`closing`), free the program's state and check what the
timed path produced against the plain reference. The last line of standard output
is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device`, with `--trace 1` a `breakdown`, and last the
`checks`, each number compared beside its limit (also the last lines of
standard error).

Exit codes: 2 without enough CUDA devices, 3 when JAX, flax or the JAX
package was imported, 1 on any other failure; no result is printed then.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "lossyless_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started (10 ms steps)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def set_caches(root: Path):
    """Every compile cache in a fixed directory inside the checkout. The
    program's own nvcc and g++ builds go to `lossyless_tpu_torch/_build/`
    there already."""
    base = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(chips: int) -> dict:
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60).stdout.split()
        info["power_limit_w"] = float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", started: float | None = None,
             bench_dir: Path | None = None) -> dict:
    """One run of cell `name`: the result's fields, `checks` last.
    `bench_dir` (the package's directory unless given) holds the
    configurations, mixes and metric readers."""
    import torch

    from benchmark import cells

    started = process_start() if started is None else started
    bench_dir = cells.HERE if bench_dir is None else Path(bench_dir)
    cell = cells.load_cell(root, name, bench_dir)
    session = cells.driver(cell).Session(cell, seed, device)
    session.setup()
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.time() - started
    window = session.window(seconds)
    sliced = session.trace() if trace else None
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    session.closing()
    session.free()
    t0 = time.time()
    checks = session.check()
    session.info["check_s"] = time.time() - t0
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        record = cells.Record(cell, window, sliced, session.info)
        metrics = {}
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"], bench_dir)(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(window, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": correct, "attempted": session.attempted,
              "failed": session.failed, "metrics": metrics,
              "device": {"memory_peak_bytes": peak}}
    if trace:
        result["device"].update(busy_s=sliced.busy_s(),
                                window_s=sliced.window_s)
        result["breakdown"] = {"device_ops": sliced.top_device_ops(),
                               "idle_gaps": sliced.idle_gaps()}
    result["checks"] = checks
    print("info " + json.dumps(session.info), file=sys.stderr)
    return result


def main(argv=None) -> int:
    started = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    set_caches(root)
    import torch

    from benchmark import cells

    chips = cells.load_cell(root, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"imported {found}: the run must not load JAX or the JAX "
              f"package", file=sys.stderr)
        return 3
    device = card(chips)
    device.update(result["device"])
    result["device"] = device
    for k, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
