"""The port imports nothing of JAX, flax or the JAX package.

An `ast` scan of every module of `lossyless_tpu_torch/` and of
`chip_smoke.py`, not a `sys.modules` check: the test process may have JAX
imported already (tests/conftest.py imports it), so only the source says
what the port itself imports.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "lossyless_tpu")
FILES = sorted((ROOT / "lossyless_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_the_scan_covers_the_port():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "lossyless_tpu_torch/hub/compressor.py" in names
    assert "lossyless_tpu_torch/nn/flash_attn.py" in names
    assert len(names) >= 15


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_the_scan_catches_a_jax_import():
    for src in ("import jax.numpy as jnp", "from flax import linen",
                "from lossyless_tpu.coding import rans",
                "importlib.import_module('jax')"):
        assert [m for m in _imported(ast.parse(src))
                if m.split(".")[0] in FORBIDDEN], src
