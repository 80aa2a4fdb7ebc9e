"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package
(top-level names compared whole: `lossyless_tpu_torch` is the program);
the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

from benchmark.tests.conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "lossyless_tpu"}

RUN = """
import json, sys
from pathlib import Path
sys.path.insert(0, {repo!r})
import benchmark.calibrate, benchmark.faults
from benchmark import cells, run
for m in json.load(open(Path({root!r}) / "BENCHMARK.json"))["per_layer"]:
    cells.metric_reader(m["name"], Path({bench!r}))
run.run_cell(Path({root!r}), "vitb32.encode_stl10", 3, 0.0, True, "cpu",
             bench_dir=Path({bench!r}))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tiny):
    root, bench = tiny
    loaded = _modules(RUN.format(repo=str(REPO), root=str(root),
                                 bench=str(bench)))
    assert "lossyless_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules(
        f"import sys, json; sys.path.insert(0, {str(REPO)!r}); "
        "import benchmark.reference.coding, benchmark.reference.vit, "
        "benchmark.reference.bince; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not loaded & (FORBIDDEN | {"lossyless_tpu_torch"})
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = {node.module.split(".")[0]}
            else:
                continue
            assert tops <= {"math", "struct", "numpy", "torch",
                            "__future__"}, (path.name, tops)
