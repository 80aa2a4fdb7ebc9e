"""The port imports nothing of JAX, flax or the JAX package.

An `ast` scan of every module of `lossyless_tpu_torch/` and of
`chip_smoke.py`, not a `sys.modules` check: the test process may have JAX
imported already (tests/conftest.py imports it), so only the source says
what the port itself imports.
"""

import ast
import subprocess
import sys
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
    assert "lossyless_tpu_torch/core/mesh.py" in names
    assert set(NEW_MODULES) <= {n[:-3].replace("/", ".") for n in names}
    assert len(names) >= 15


# the modules of the training path (slice 2), of the hyperprior path with
# its communication stage (slice 3) and of the CLI, bench and pipeline
# (slice 9)
NEW_MODULES = [
    "lossyless_tpu_torch.nn.flash_attn",
    "lossyless_tpu_torch.coding.rans",
    "lossyless_tpu_torch.coding.gaussian_conditional",
    "lossyless_tpu_torch.nn.layers",
    "lossyless_tpu_torch.nn.mlp",
    "lossyless_tpu_torch.train.metrics",
    "lossyless_tpu_torch.train.loggers",
    "lossyless_tpu_torch.train.checkpoints",
    "lossyless_tpu_torch.core.annealer",
    "lossyless_tpu_torch.compressors.distributions",
    "lossyless_tpu_torch.coding.eb_kernel",
    "lossyless_tpu_torch.compressors.rates",
    "lossyless_tpu_torch.compressors.distortions",
    "lossyless_tpu_torch.nn.registry",
    "lossyless_tpu_torch.compressors.compressor",
    "lossyless_tpu_torch.train.state",
    "lossyless_tpu_torch.pipeline.config",
    "lossyless_tpu_torch.pipeline.run",
    "lossyless_tpu_torch.hub.save_hub",
    # slice 9: the CLI, the bench and the three-stage pipeline
    "lossyless_tpu_torch.analysis.linear_eval",
    "lossyless_tpu_torch.data.balancing",
    "lossyless_tpu_torch.data.features",
    "lossyless_tpu_torch.data.images",
    "lossyless_tpu_torch.data.loader",
    "lossyless_tpu_torch.pipeline.predictor",
    "lossyless_tpu_torch.hub.cli",
    "lossyless_tpu_torch.bench",
    # slice 10: the banana experiments and the experiment CLI
    "lossyless_tpu_torch.data.banana",
    "lossyless_tpu_torch.cli",
    # slice 11: the augmented-MNIST image path
    "lossyless_tpu_torch.core.math",
    "lossyless_tpu_torch.nn.resnet",
    "lossyless_tpu_torch.nn.cnn",
    "lossyless_tpu_torch.nn.pretrained",
    "lossyless_tpu_torch.data.augmentations",
    # slice 12: the STL10 experiments (BALLE, GDN, the spatial hyperprior
    # live in nn/cnn.py, nn/layers.py and compressors/rates.py)
    "lossyless_tpu_torch.data.label_augment",
    # slice 13: the pretrained towers and their converters
    "lossyless_tpu_torch.nn.clip_resnet",
    "lossyless_tpu_torch.nn.convert_resnet",
    "lossyless_tpu_torch.nn.clip_text",
    # slice 14: the devices, process groups and collectives
    "lossyless_tpu_torch.core.mesh",
    # slice 15: the external datasets and their ingestion, the kaggle
    # writer, the search, the timers, the RNG helper and the profiler
    "lossyless_tpu_torch.core.rng",
    "lossyless_tpu_torch.core.timing",
    "lossyless_tpu_torch.core.profiling",
    "lossyless_tpu_torch.data.norms",
    "lossyless_tpu_torch.data.ingest",
    "lossyless_tpu_torch.data.external",
    "lossyless_tpu_torch.analysis.kaggle",
    "lossyless_tpu_torch.pipeline.hypopt",
]


def test_the_training_path_imports_with_jax_blocked():
    """A fresh interpreter in which importing jax, flax, optax or the JAX
    package fails imports every module of the training and hyperprior
    paths."""
    block = "; ".join(f"sys.modules[{m!r}] = None" for m in FORBIDDEN)
    code = (f"import sys; {block}; import importlib; "
            f"[importlib.import_module(m) for m in {NEW_MODULES!r}]; "
            f"print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_the_entry_points_import_without_sklearn_and_pil():
    """sklearn (the CLI's `eval`) and PIL (folder inputs, `--folder-fed`)
    are imported where they are used: the CLI, the bench and the pipeline
    import without them, JAX blocked too."""
    hidden = FORBIDDEN + ("sklearn", "PIL")
    block = "; ".join(f"sys.modules[{m!r}] = None" for m in hidden)
    mods = ["lossyless_tpu_torch.hub.cli", "lossyless_tpu_torch.bench",
            "lossyless_tpu_torch.pipeline.run"]
    code = (f"import sys; {block}; import importlib; "
            f"[importlib.import_module(m) for m in {mods!r}]; "
            f"print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


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
