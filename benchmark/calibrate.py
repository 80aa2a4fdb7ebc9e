"""Readings from which the comparison's limits are set.

    python3 -m benchmark.calibrate --workload NAME --seeds 1,2,3 \\
        --seconds 3 [--control]

For each seed, in one process: set the cell up, run a short window and
what the check follows after it (`closing`), free
the program's state and print the numbers its check compares (the
program's readings, whose largest over a dozen seeds or more is the lower
reading of each limit); with `--control` also the numbers of the control,
the reference in the next precision down put in the program's place (the
smallest over three seeds or more is the upper reading). With `--fault`
the program runs with that fault of `faults.py` planted. One JSON line a
seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

from benchmark.run import set_caches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=3.0,
                   help="the window's length (at least one pass or epoch "
                        "runs)")
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None,
                   help="plant this fault of `faults.py` under the program")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    root = Path.cwd()
    set_caches(root)
    import torch

    from benchmark import cells, faults

    cell = cells.load_cell(root, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        fault = faults.plant(args.fault, cell.traffic["driver"]) \
            if args.fault else contextlib.nullcontext()
        t0 = time.time()
        session = cells.driver(cell).Session(cell, seed, args.device)
        with fault:
            session.setup()
            session.window(args.seconds)
            session.closing()
        session.free()
        checks = session.check()
        line = {"seed": seed, "fault": args.fault,
                "program": {k: c["value"] for k, c in checks.items()},
                "stages": {k: v for k, v in session.info.items()
                           if k.endswith("_numbers")}}
        if args.control:
            line["control"] = session.control()
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
        del session
        gc.collect()
        if args.device != "cpu":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
