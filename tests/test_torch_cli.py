"""The port's deployment CLI (`lossyless_tpu_torch.hub.cli`) against the
JAX package's (`lossyless_tpu.hub.cli`).

Both CLIs resolve `--beta b005` to the same seeded rate file, written in
the published layout under a temporary `REFERENCE_HUB`, and load the same
tiny OpenAI-layout CLIP state dict (`--arch tiny --clip-weights`), in
fp32, on the same inputs. Symbols may flip where a value lands within
float roundoff of a rounding boundary (the towers sum in different
orders): at most 0.1% of them. Streams are byte-equal wherever the
symbols are equal; `info` prints the same line; `decompress` gives the
same features (1e-5) and `eval` the same accuracy.
"""

import os
import re

import numpy as np
import pytest
import torch

from lossyless_tpu.hub import cli as jcli
from lossyless_tpu.hub import load_reference as jref
from lossyless_tpu_torch.coding.bitstream import read_dataset
from lossyless_tpu_torch.hub import cli as tcli
from lossyless_tpu_torch.hub import load_reference as tref
from lossyless_tpu_torch.hub.compressor import load_pretrained
from tests.test_torch_coding import random_eb_params
from tests import torch_threads  # noqa: F401  (one pool a worker)

WIDTH, LAYERS, PATCH = 64, 2, 32


def write_published_rate(path, seed: int = 3):
    """A factorized rate file in the published `factorized_rate.pt` layout
    (`entropy_bottleneck._matrix{i}` ..., `quantiles`, `scaling`,
    `biasing`), from seeded parameters."""
    rng = np.random.default_rng(seed)
    sd = {f"entropy_bottleneck.{'' if k == 'quantiles' else '_'}{k}":
          torch.from_numpy(v) for k, v in random_eb_params(seed).items()}
    sd["scaling"] = torch.from_numpy(
        rng.normal(2.0, 0.3, 512).astype(np.float32))
    sd["biasing"] = torch.from_numpy(
        rng.normal(0.0, 0.1, 512).astype(np.float32))
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(sd, path)


def tiny_openai_clip(seed: int = 0) -> dict:
    """A tiny visual tower in OpenAI CLIP's state-dict layout."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, std=0.05):
        return torch.randn(shape, generator=g) * std

    w, n = WIDTH, (224 // PATCH) ** 2 + 1
    sd = {"visual.conv1.weight": r(w, 3, PATCH, PATCH, std=0.02),
          "visual.class_embedding": r(w),
          "visual.positional_embedding": r(n, w),
          "visual.ln_pre.weight": 1 + r(w), "visual.ln_pre.bias": r(w),
          "visual.ln_post.weight": 1 + r(w), "visual.ln_post.bias": r(w),
          "visual.proj": r(w, 512, std=0.1)}
    for i in range(LAYERS):
        p = f"visual.transformer.resblocks.{i}"
        sd.update({
            f"{p}.ln_1.weight": 1 + r(w), f"{p}.ln_1.bias": r(w),
            f"{p}.ln_2.weight": 1 + r(w), f"{p}.ln_2.bias": r(w),
            f"{p}.attn.in_proj_weight": r(3 * w, w, std=0.1),
            f"{p}.attn.in_proj_bias": r(3 * w),
            f"{p}.attn.out_proj.weight": r(w, w, std=0.1),
            f"{p}.attn.out_proj.bias": r(w),
            f"{p}.mlp.c_fc.weight": r(4 * w, w, std=0.1),
            f"{p}.mlp.c_fc.bias": r(4 * w),
            f"{p}.mlp.c_proj.weight": r(w, 4 * w, std=0.1),
            f"{p}.mlp.c_proj.bias": r(w)})
    return sd


@pytest.fixture()
def env(tmp_path, monkeypatch):
    hub = tmp_path / "hub"
    write_published_rate(hub / tref.BETA_DIRS["b005"] / "factorized_rate.pt")
    monkeypatch.setattr(jref, "REFERENCE_HUB", hub)
    monkeypatch.setattr(tref, "REFERENCE_HUB", hub)
    clip = tmp_path / "clip.pt"
    torch.save(tiny_openai_clip(), clip)
    rng = np.random.default_rng(1)
    np.savez(tmp_path / "in.npz",
             x=rng.integers(0, 256, (6, 96, 96, 3), dtype=np.uint8),
             y=np.arange(6) % 3)
    from PIL import Image

    for cname in ("cats", "dogs"):
        (tmp_path / "imgs" / cname).mkdir(parents=True)
        for i, hw in enumerate(((40, 48), (96, 96), (120, 70))):
            Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
                            ).save(tmp_path / "imgs" / cname / f"{i}.png")
    return tmp_path, ["--arch", "tiny", "--dtype", "float32",
                      "--clip-weights", str(clip)]


def _symbols(path):
    comp = load_pretrained("b005", device="cpu")
    return comp.codec.decode_batch(list(read_dataset(path)), comp.indexes)


INPUTS = {"npz": ("in.npz", []),
          "npz_device_preprocess": ("in.npz", ["--device-preprocess", "96",
                                                "96"]),
          "folder": ("imgs", [])}


@pytest.mark.parametrize("case", list(INPUTS))
def test_compress_matches_jax(env, case, capsys):
    tmp, model = env
    src, extra = INPUTS[case]
    out = {}
    for name, cli, dev in (("jax", jcli, []), ("port", tcli,
                                                ["--device", "cpu"])):
        f, lf = tmp / f"{name}.bin", tmp / f"{name}.npy"
        rc = cli.main(["compress", str(tmp / src), str(f), "--labels",
                       str(lf), "--batch-size", "4", *extra, *model, *dev])
        assert rc == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert re.fullmatch(r"Rate: [\d.]+ bits/img \| Encoding: [\d.]+ "
                            r"img/sec", line), line
        out[name] = (list(read_dataset(f)), np.load(lf))
    (js, jy), (ts, ty) = out["jax"], out["port"]
    np.testing.assert_array_equal(ty, jy)
    jsym, tsym = _symbols(tmp / "jax.bin"), _symbols(tmp / "port.bin")
    flips = int((jsym != tsym).sum())
    print(f"symbol flips port vs JAX ({case}): {flips} of {jsym.size}")
    assert flips <= 1e-3 * jsym.size
    same = np.all(jsym == tsym, axis=1)
    assert same.any()
    for i in np.flatnonzero(same):
        assert ts[i] == js[i]


def test_info_decompress_and_eval_match_jax(env, capsys):
    tmp, model = env
    data = tmp / "ds.bin"
    assert jcli.main(["compress", str(tmp / "in.npz"), str(data),
                      "--labels", str(tmp / "y.npy"), *model]) == 0
    capsys.readouterr()
    lines = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        assert cli.main(["info", str(data)]) == 0
        lines[name] = capsys.readouterr().out
    assert lines["port"] == lines["jax"]
    assert "6 images" in lines["port"]

    feats = {}
    for name, cli, dev in (("jax", jcli, []), ("port", tcli,
                                                ["--device", "cpu"])):
        z = tmp / f"z_{name}.npz"
        assert cli.main(["decompress", str(data), str(z), "--labels",
                         str(tmp / "y.npy"), *model, *dev]) == 0
        line = capsys.readouterr().out.strip()
        assert line == f"Decoded 6 x 512-d features -> {z}"
        feats[name] = np.load(z)
    np.testing.assert_allclose(feats["port"]["z"], feats["jax"]["z"],
                               atol=1e-5)
    np.testing.assert_array_equal(feats["port"]["y"], feats["jax"]["y"])

    acc = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        z = str(tmp / f"z_{name}.npz")
        assert cli.main(["eval", z, z, "--C", "0.5"]) == 0
        line = capsys.readouterr().out.strip()
        acc[name] = re.match(r"Accuracy: ([\d.]+)% \| Training time: "
                             r"[\d.]+ sec \| C: 0.5$", line).group(1)
    assert acc["port"] == acc["jax"]


def test_jpeg_draft_is_a_parameter_and_leaves_the_environment(env, capsys,
                                                              monkeypatch):
    tmp, model = env
    from PIL import Image

    jpgs = tmp / "jpgs" / "a"
    jpgs.mkdir(parents=True)
    rng = np.random.default_rng(5)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (600, 520, 3), dtype=np.uint8)
                        ).save(jpgs / f"{i}.jpg")
    monkeypatch.delenv("LOSSYLESS_JPEG_DRAFT", raising=False)
    args = ["compress", str(tmp / "jpgs"), None, *model, "--device", "cpu"]
    # (output, --jpeg-draft, LOSSYLESS_JPEG_DRAFT)
    for name, flag, env_draft in (("full", False, None),
                                  ("flag", True, None), ("env", False, "1")):
        if env_draft is not None:
            monkeypatch.setenv("LOSSYLESS_JPEG_DRAFT", env_draft)
        before = dict(os.environ)
        args[2] = str(tmp / f"{name}.bin")
        assert tcli.main(args + (["--jpeg-draft"] if flag else [])) == 0
        assert dict(os.environ) == before
    capsys.readouterr()
    # the draft decode reaches the pixels: the streams differ
    assert list(read_dataset(tmp / "flag.bin")) != \
        list(read_dataset(tmp / "full.bin"))
    # without the flag the variable asks for it, as in the JAX CLI
    assert list(read_dataset(tmp / "env.bin")) == \
        list(read_dataset(tmp / "flag.bin"))
    with pytest.raises(SystemExit, match="no effect"):
        tcli.main(["compress", str(tmp / "in.npz"), str(tmp / "x.bin"),
                   "--jpeg-draft", *model, "--device", "cpu"])


def test_mesh_above_one_raises_and_names_the_queue(env):
    """`--mesh N > 1` is ported (ROADMAP queue 1 order 8): on the CPU it
    encodes over N replicas with the one-device streams, ragged tail
    included (6 images over 4); over CUDA devices it raises when fewer are
    visible, naming the count."""
    tmp, model = env
    assert tcli.main(["compress", str(tmp / "in.npz"), str(tmp / "one.bin"),
                      *model, "--device", "cpu"]) == 0
    assert tcli.main(["compress", str(tmp / "in.npz"), str(tmp / "m4.bin"),
                      "--mesh", "4", *model, "--device", "cpu"]) == 0
    assert list(read_dataset(tmp / "m4.bin")) == \
        list(read_dataset(tmp / "one.bin"))
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="n_devices=2"):
            tcli.main(["compress", str(tmp / "in.npz"), str(tmp / "x.bin"),
                       "--mesh", "2", *model, "--device", "cuda"])


def test_decompress_never_builds_the_tower(env, monkeypatch):
    tmp, model = env
    data = tmp / "ds.bin"
    assert tcli.main(["compress", str(tmp / "in.npz"), str(data), *model,
                      "--device", "cpu"]) == 0
    from lossyless_tpu_torch.hub.compressor import ClipCompressor

    def refuse(self):
        raise AssertionError("decompress built the tower")

    monkeypatch.setattr(ClipCompressor, "_ensure_tower", refuse)
    assert tcli.main(["decompress", str(data), str(tmp / "z.npz"),
                      "--device", "cpu"]) == 0
    assert np.load(tmp / "z.npz")["z"].shape == (6, 512)


def test_info_needs_no_card(env, capsys, monkeypatch):
    tmp, model = env
    data = tmp / "ds.bin"
    assert tcli.main(["compress", str(tmp / "in.npz"), str(data), *model,
                      "--device", "cpu"]) == 0

    def refuse(*a, **k):
        raise AssertionError("info touched a device")

    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    assert tcli.main(["info", str(data)]) == 0
    assert "6 images" in capsys.readouterr().out
