"""The public-checkpoint converters, `load_pretrained_encoder` and the
three `ssl_*` presets against the JAX package.

No published checkpoint is in the repository: the state dicts are built
from a seed in the public layouts by chip_smoke.py's functions (OpenAI's
`visual.*` ModifiedResNet keys in fp16, as CLIP ships them; torchvision's
ResNet-50 keys) and by `_tiny_vit` (OpenAI's ViT keys). Each goes to
both packages' converters and loaders.

Tolerances: converted and loaded trees bit for bit; a resampled
positional embedding 2e-6 (the port contracts `jax.image.resize`'s cubic
matrices one axis at a time, XLA in one einsum), its lead token bit for
bit; towers fp32 rtol 1e-5; the 3-step slice's logs rtol 1e-4 and its
variables at tests/test_torch_training.py's fp32 allowances (rtol 1e-4,
atol 1e-5), the frozen tower's parameters bit-identical to their start.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lossyless_tpu.compressors.compressor import LearnableCompressor as JLC
from lossyless_tpu.nn import clip_resnet as jcr
from lossyless_tpu.nn import convert_resnet as jconv
from lossyless_tpu.nn import pretrained as jpre
from lossyless_tpu.nn import registry as jreg
from lossyless_tpu.pipeline import config as jconfig
from lossyless_tpu.train import state as jstate
from lossyless_tpu_torch.compressors import compressor as tcomp
from lossyless_tpu_torch.nn import clip_resnet as tcr
from lossyless_tpu_torch.nn import convert_resnet as tconv
from lossyless_tpu_torch.nn import layers as tlayers
from lossyless_tpu_torch.nn import pretrained as tpre
from lossyless_tpu_torch.nn import resnet as tresnet
from lossyless_tpu_torch.nn import vit as tvit
from lossyless_tpu_torch.pipeline import config as tconfig
from lossyless_tpu_torch.pipeline import run as trun
from lossyless_tpu_torch.train import checkpoints as tckpt
from lossyless_tpu_torch.train import state as tstate

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from tests import torch_threads  # noqa: F401  (one pool a worker)

TINY_RN = dict(width=16, layers=(1, 1, 1, 1))
TINY_KW = ["encoder.arch_kwargs.width=16",
           "encoder.arch_kwargs.layers=[1,1,1,1]",
           "encoder.arch_kwargs.heads=4"]


def _rn50_dict(grid=7, prefix="visual.", dtype=torch.float16, seed=0):
    return chip_smoke.openai_rn50_state_dict(out_dim=8, grid=grid, seed=seed,
                                             prefix=prefix, dtype=dtype,
                                             **TINY_RN)


def _tiny_vit(width=32, layers=2, patch=32, grid=7, out=8, seed=0):
    """A tiny visual tower in OpenAI CLIP's ViT layout, fp16."""
    _, r = chip_smoke._seeded(seed)
    w = width
    sd = {"conv1.weight": r(w, 3, patch, patch, std=0.02),
          "class_embedding": r(w), "positional_embedding": r(grid ** 2 + 1,
                                                             w),
          "ln_pre.weight": 1 + r(w), "ln_pre.bias": r(w),
          "ln_post.weight": 1 + r(w), "ln_post.bias": r(w),
          "proj": r(w, out, std=0.1)}
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        for name, shape in (("ln_1.weight", (w,)), ("ln_1.bias", (w,)),
                            ("ln_2.weight", (w,)), ("ln_2.bias", (w,)),
                            ("attn.in_proj_weight", (3 * w, w)),
                            ("attn.in_proj_bias", (3 * w,)),
                            ("attn.out_proj.weight", (w, w)),
                            ("attn.out_proj.bias", (w,)),
                            ("mlp.c_fc.weight", (4 * w, w)),
                            ("mlp.c_fc.bias", (4 * w,)),
                            ("mlp.c_proj.weight", (w, 4 * w)),
                            ("mlp.c_proj.bias", (w,))):
            sd[f"{p}.{name}"] = r(*shape, std=0.1)
    return {"visual." + k: v.half() for k, v in sd.items()}


def _flat(params, stats=None):
    return tlayers.params_from_flax(tlayers.merge_stats(
        jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, stats or {})))


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# ---------------------------------------------------------------------------
# The converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["bare-fp32", "visual-fp16", "clip-fp16"])
def test_convert_clip_resnet_matches_jax(form):
    """Bare fp32 keys, the visual tower's fp16 keys under `visual.`, and a
    full CLIP state dict (the text tower's keys beside `visual.*`): both
    converters give the same arrays; the towers the same embedding."""
    sd = _rn50_dict(prefix="" if form == "bare-fp32" else "visual.",
                    dtype=None if form == "bare-fp32" else torch.float16)
    if form == "clip-fp16":
        sd.update(chip_smoke.openai_clip_text_state_dict(
            vocab=50, context=8, width=16, layers=1, out_dim=8,
            dtype=torch.float16))
    params, stats = jcr.convert_clip_resnet(sd)
    got = tcr.convert_clip_resnet(sd)
    _equal(got, _flat(params, stats))
    if form != "visual-fp16":
        return
    x = np.random.default_rng(0).normal(size=(2, 224, 224, 3)).astype(
        np.float32)
    want = jax.jit(jcr.ClipResNet(out_dim=8, heads=4, **TINY_RN).apply)(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    tm = tcr.ClipResNet(8, (224, 224, 3), heads=4, **TINY_RN)
    tm.load_state_dict(got)
    out = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_convert_torchvision_resnet_matches_jax():
    """The flax trees of both converters bit for bit, with and without
    the head; after `params_from_flax` they cover every tensor of the
    port's ResNet-50 with its shapes; `load_into` keeps the head that the
    converter skipped."""
    sd = chip_smoke.torchvision_resnet50_state_dict()
    for head in (False, True):
        jp, js = jconv.convert_torchvision_resnet(sd, "resnet50", head)
        tp, ts = tconv.convert_torchvision_resnet(sd, "resnet50", head)
        assert jax.tree.structure(jp) == jax.tree.structure(tp)
        assert jax.tree.structure(js) == jax.tree.structure(ts)
        for a, b in zip(jax.tree.leaves((jp, js)), jax.tree.leaves((tp, ts))):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    model = tresnet.ResNet(1000, (224, 224, 3), base="resnet50")
    target = model.state_dict()
    flat = _flat(tp, ts)
    assert set(flat) == set(target)
    assert all(flat[k].shape == v.shape for k, v in target.items())
    merged = tconv.load_into(target, *tconv.convert_torchvision_resnet(sd))
    assert torch.equal(merged["Dense_0.kernel"], target["Dense_0.kernel"])
    assert torch.equal(merged["Conv_0.kernel"], flat["Conv_0.kernel"])


# ---------------------------------------------------------------------------
# load_pretrained_encoder, both loaders on the same files
# ---------------------------------------------------------------------------


def _port_model(arch, in_shape, z_dim, kw=()):
    cfg = tconfig.apply_overrides(tconfig.preset("ssl_bottleneck_pretrain"), [
        f"encoder.arch={arch}", f"encoder.z_dim={z_dim}", *kw])
    cfg.in_shape = in_shape
    return cfg, trun.build_state(cfg, 1, device="cpu").model


def _jax_load(cfg, in_shape, path):
    """JAX's loader on a mapper initialized with zeros (its shapes from
    `jax.eval_shape`, no compile): (params, batch_stats) flax trees."""
    jarch = jreg.get_architecture(cfg.encoder.arch, in_shape,
                                  cfg.encoder.z_dim, **cfg.encoder.arch_kwargs)
    shapes = jax.eval_shape(jarch.init, jax.random.key(0),
                            jnp.zeros((1, *in_shape)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats = jpre.load_pretrained_encoder(
        cfg.encoder, {"p_ZlX": {"mapper": zeros["params"]}},
        {"p_ZlX": {"mapper": zeros.get("batch_stats", {})}}
        if "batch_stats" in zeros else {}, str(path))
    return (params["p_ZlX"]["mapper"],
            (stats or {}).get("p_ZlX", {}).get("mapper", {}))


def _check_loaded(model, jax_mapper, jax_stats, loaded_keys):
    """The port's `p_ZlX.mapper.*` entries the checkpoint names equal JAX's
    loaded tree bit for bit, the positional embeddings to 2e-6 with the
    lead token bit for bit."""
    want = _flat(jax_mapper, jax_stats)
    sd = model.state_dict()
    assert loaded_keys and loaded_keys <= set(want)
    for k in loaded_keys:
        got = sd["p_ZlX.mapper." + k]
        if k.endswith("positional_embedding"):
            assert torch.equal(got[0], want[k][0]), k
            np.testing.assert_allclose(got.numpy(), want[k].numpy(), rtol=0,
                                       atol=2e-6, err_msg=k)
        else:
            assert torch.equal(got, want[k]), k


@pytest.mark.parametrize("side,grid", [(96, 3), (64, 2)])
def test_loader_converts_openai_rn50_and_resamples_pe(side, grid, tmp_path):
    """An OpenAI RN50 dict at the 224 px grid (7 x 7) into towers at 96 px
    (7 -> 3) and 64 px (7 -> 2)."""
    path = tmp_path / "rn50.pt"
    torch.save(_rn50_dict(), path)
    cfg, model = _port_model("clip_rn50", (side, side, 3), 8, TINY_KW)
    tpre.load_pretrained_encoder(cfg.encoder, model, str(path))
    assert model.p_ZlX.mapper.attnpool.positional_embedding.shape[0] == \
        grid * grid + 1
    jm, js = _jax_load(cfg, (side, side, 3), path)
    _check_loaded(model, jm, js, set(tcr.convert_clip_resnet(_rn50_dict())))


@functools.lru_cache(maxsize=None)
def _torchvision():
    return chip_smoke.torchvision_resnet50_state_dict(seed=4)


@pytest.mark.parametrize("prefix", jpre._SSL_PREFIXES)
def test_loader_strips_each_ssl_prefix(prefix, tmp_path):
    """A torchvision ResNet-50 under each SSL prefix, nested under
    `state_dict` as pl_bolts saves it, into the `simclr` tower; the
    classifier head keeps its init on both sides."""
    assert tpre._SSL_PREFIXES == jpre._SSL_PREFIXES
    sd = _torchvision()
    path = tmp_path / "ssl.pth"
    torch.save({"state_dict": {prefix + k: v for k, v in sd.items()},
                "epoch": 3}, path)
    cfg, model = _port_model("simclr", (112, 112, 3), 16)
    head = model.p_ZlX.mapper.Dense_0.kernel.clone()
    tpre.load_pretrained_encoder(cfg.encoder, model, str(path))
    jm, js = _jax_load(cfg, (112, 112, 3), path)
    _check_loaded(model, jm, js, set(_flat(*jconv.convert_torchvision_resnet(
        sd))))
    assert torch.equal(model.p_ZlX.mapper.Dense_0.kernel, head)


@pytest.mark.parametrize("side", [224, 96])
def test_loader_converts_an_openai_vit(side, tmp_path):
    """A tiny OpenAI CLIP ViT (`.bin`), at its grid and resampled 7 -> 3."""
    path = tmp_path / "vit.bin"
    torch.save(_tiny_vit(), path)
    kw = ["encoder.arch_kwargs.width=32", "encoder.arch_kwargs.layers=2",
          "encoder.arch_kwargs.heads=2", "encoder.arch_kwargs.patch_size=32"]
    cfg, model = _port_model("clip", (side, side, 3), 8, kw)
    tpre.load_pretrained_encoder(cfg.encoder, model, str(path))
    jm, _ = _jax_load(cfg, (side, side, 3), path)
    want = tvit.params_from_flax(jax.tree.map(np.asarray, jm))
    sd = model.state_dict()
    for k, v in want.items():
        got = sd["p_ZlX.mapper." + k]
        if k == "positional_embedding":
            assert torch.equal(got[0], v[0])
            np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=0,
                                       atol=2e-6)
        else:
            assert torch.equal(got, v), k
    assert len(want) == len([k for k in sd if k.startswith("p_ZlX.")])


@pytest.mark.parametrize("src,dst", [(7, 3), (7, 2), (3, 7), (7, 1)])
def test_pe_resampling_matches_jax(src, dst):
    """The port's resampling against JAX's `_adapt_positional_embeddings`
    (`jax.image.resize(..., "cubic")`): 2e-6, the lead token bit for bit;
    a count that is not 1 + a square is left for the shape check."""
    pe = np.random.default_rng(src * 10 + dst).normal(
        size=(src * src + 1, 24)).astype(np.float32)
    init = {"attnpool": {"positional_embedding":
                         np.zeros((dst * dst + 1, 24), np.float32)}}
    want = jpre._adapt_positional_embeddings(
        init, {"attnpool": {"positional_embedding": pe}})
    want = want["attnpool"]["positional_embedding"]
    got = tpre.resample_positional_embedding(torch.from_numpy(pe),
                                             dst * dst + 1)
    assert torch.equal(got[0], torch.from_numpy(pe[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    assert tpre.resample_positional_embedding(torch.from_numpy(pe[:-1]),
                                              dst * dst + 1) is None


def test_loader_errors(tmp_path):
    """A pe of 1 + 48 tokens (not a square grid) falls to the shape check;
    an unknown layout raises the converter's error naming the arch; an
    arch with no converter names the supported ones; a directory names the
    formats this package reads."""
    cfg, model = _port_model("clip_rn50", (96, 96, 3), 8, TINY_KW)
    sd = _rn50_dict()
    sd["visual.attnpool.positional_embedding"] = \
        sd["visual.attnpool.positional_embedding"][:-1]
    torch.save(sd, tmp_path / "odd.pt")
    with pytest.raises(ValueError, match="do not fit"):
        tpre.load_pretrained_encoder(cfg.encoder, model,
                                     str(tmp_path / "odd.pt"))
    torch.save({"visual.conv1.weight": torch.zeros(8, 3, 3, 3)},
               tmp_path / "partial.pt")
    with pytest.raises(ValueError, match="converter for encoder.arch="
                                         "'clip_rn50'.*supported"):
        tpre.load_pretrained_encoder(cfg.encoder, model,
                                     str(tmp_path / "partial.pt"))
    with pytest.raises(ValueError, match="no pretrained-weight converter"):
        tpre._convert_for_arch("mlp", {})
    with pytest.raises(NotImplementedError, match="save_weights export.*"
                                                  "npz"):
        tpre.load_pretrained_encoder(cfg.encoder, model, str(tmp_path))


# ---------------------------------------------------------------------------
# The presets
# ---------------------------------------------------------------------------

SSL = ("ssl_bottleneck_pretrain", "ssl_bottleneck_linear_eval",
       "ssl_bottleneck_mlp_eval")


@pytest.mark.parametrize("name", SSL)
def test_ssl_presets_match_jax(name):
    ov = ["rate.eb_use_pallas=True", "encoder.arch=swav",
          "encoder.z_dim=2048", "trainer.precision=bf16"]
    for overrides in ([], ov):
        j = jconfig.apply_precision(jconfig.apply_overrides(
            jconfig.preset(name), overrides))
        t = tconfig.apply_precision(tconfig.apply_overrides(
            tconfig.preset(name), overrides))
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert t.long_name == j.long_name
    t = tconfig.preset(name)
    assert (t.encoder.arch, t.encoder.z_dim, t.rate.mode, t.loss.beta,
            t.frozen, t.rate.is_endToEnd) == ("clip_rn50", 1024, "H_hyper",
                                               1e-3, ("p_ZlX",), False)


# ---------------------------------------------------------------------------
# The slice: a tiny ssl_bottleneck_pretrain compressor, 3 train steps
# ---------------------------------------------------------------------------

STEPS, B, IN_SHAPE = 3, 4, (64, 64, 3)
# fp32: `preset()` makes every non-banana preset bf16 (JAX config.py:
# 286-292); the ssl tower's fp32 path is the one K2 gains here
SLICE = ["rate.eb_use_pallas=True", "encoder.z_dim=32",
         "data_feat.batch_size=4",
         "trainer.precision=fp32", *TINY_KW]


def _jax_pair_noise(key, side, z_dim):
    """The hyperprior rate's two draws (JAX rates.py:229)."""
    r1, r2 = jax.random.split(key)
    return tuple(np.array(jax.random.uniform(r, s, jnp.float32, -0.5, 0.5))
                 for r, s in ((r1, (B, side)), (r2, (B, z_dim))))


@functools.lru_cache(maxsize=None)
def _slice():
    jcfg, tcfg = (c.apply_precision(c.apply_overrides(
        c.preset("ssl_bottleneck_pretrain"), SLICE)) for c in (jconfig,
                                                               tconfig))
    jcfg.in_shape = tcfg.in_shape = IN_SHAPE
    rng = np.random.default_rng(7)
    batches = [(rng.normal(size=(B, *IN_SHAPE)).astype(np.float32),
                np.zeros(B, np.int32), np.zeros(B, np.float32))
               for _ in range(STEPS)]
    opts = [jstate.bind_schedule_steps(o, STEPS, STEPS)
            for o in (jcfg.optimizer_feat, jcfg.optimizer_online,
                      jcfg.optimizer_coder)]
    js = jstate.TrainState.create(
        JLC(jcfg.compressor_config()), tuple(map(jnp.asarray, batches[0])),
        jax.random.key(jcfg.trainer.seed), main=opts[0], online=opts[1],
        coder=opts[2], frozen_paths=tuple(jcfg.frozen))
    start = jax.tree.map(np.asarray, (js.params, js.batch_stats))
    jlogs = []
    for step, batch in enumerate(batches):
        js, lg = jstate.train_step(js, tuple(map(jnp.asarray, batch)),
                                   jax.random.key(step))
        jlogs.append({k: float(v) for k, v in lg.items()})

    state = trun.build_state(tcfg, STEPS, STEPS, device="cpu")
    state.model.load_state_dict(tcomp.compressor_params_from_flax(*start))
    side = state.model.rate_estimator.side_z_dim
    tlogs = []
    for step, batch in enumerate(batches):
        key = jax.random.split(jax.random.key(step), 4)[1]
        noise = tuple(map(torch.from_numpy, _jax_pair_noise(
            key, side, tcfg.encoder.z_dim)))
        state, lg = tstate.train_step(state, tuple(map(torch.from_numpy,
                                                       batch)), noise=noise)
        tlogs.append({k: float(v) for k, v in lg.items()})
    return (start, jax.tree.map(np.asarray, (js.params, js.batch_stats)),
            jlogs, state, tlogs)


def test_slice_logs_match_jax():
    *_, jlogs, _, tlogs = _slice()
    for step, (j, t) in enumerate(zip(jlogs, tlogs)):
        assert set(j) == set(t) and {"H_q_ZlS", "H_q_S"} <= set(t), step
        for k in j:
            assert t[k] == pytest.approx(j[k], rel=1e-4, abs=1e-6), (step, k)


def test_slice_variables_match_jax():
    """Parameters and running statistics after 3 steps; the frozen RN50
    tower's parameters bit-identical to their start while its BatchNorm
    statistics move in train mode, as JAX's do."""
    start, end, _, state, _ = _slice()
    want = tcomp.compressor_params_from_flax(*end)
    begin = tcomp.compressor_params_from_flax(*start)
    got = state.model.state_dict()
    assert set(got) == set(want)
    params = dict(state.model.named_parameters())
    frozen = [n for n in params if tstate.param_label(n, ("p_ZlX",))
              == "frozen"]
    assert frozen and all(n.startswith("p_ZlX.") for n in frozen)
    for n in frozen:
        assert torch.equal(got[n], begin[n]) and torch.equal(want[n],
                                                             begin[n]), n
    moved = [n for n in got if n.startswith("p_ZlX.") and n.endswith(".var")]
    assert moved and all(not torch.equal(got[n], begin[n]) for n in moved)
    for n, w in want.items():
        if n not in frozen:
            np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# main of ssl_bottleneck_linear_eval on a seeded OpenAI RN50 checkpoint
# ---------------------------------------------------------------------------


def test_main_of_ssl_linear_eval_loads_and_keeps_the_tower(tmp_path):
    """Synthetic STL10 at 96 px, the tower from a 224-layout `.pt` (the
    pool's pe resampled 7 -> 3): all three stage sentinels, a finite probe
    accuracy, and the exported featurizer's tower parameters equal to the
    converted weights bit for bit."""
    path = tmp_path / "rn50.pt"
    torch.save(_rn50_dict(seed=3), path)
    cfg = tconfig.apply_overrides(tconfig.preset(
        "ssl_bottleneck_linear_eval"), [
        *TINY_KW, "encoder.z_dim=8", f"encoder.pretrained_path={path}",
        "data_feat.name=stl10", "data_pred.name=stl10",
        "data_feat.kwargs.synthetic=True", "data_feat.kwargs.synthetic_n=64",
        "data_pred.kwargs.synthetic=True", "data_pred.kwargs.synthetic_n=64",
        "data_feat.kwargs.is_augment=False", "data_feat.batch_size=16",
        "data_feat.val_batch_size=32", "data_feat.n_epochs=1",
        "predictor.n_epochs=1", "predictor.batch_size=16",
        "rate.eb_use_pallas=True", "trainer.precision=fp32",
        f"out_dir={tmp_path}/out",
        f"ckpt_dir={tmp_path}/ckpt"])
    metrics = trun.main(cfg, device="cpu")
    stage = Path(cfg.stage_dir)
    for s in ("featurizer", "communication", "predictor"):
        assert (stage / f"{s}_end.txt").exists(), s
    assert np.isfinite(metrics["test/pred/acc"])
    exported = tckpt.load_weights(Path(cfg.ckpt_dir) / cfg.long_name /
                                  "best_featurizer")
    _, model = _port_model("clip_rn50", (96, 96, 3), 8, TINY_KW)
    tpre.load_pretrained_encoder(cfg.encoder, model, str(path))
    want = model.state_dict()
    names = [n for n, _ in model.named_parameters()
             if n.startswith("p_ZlX.")]
    assert names
    for n in names:
        assert torch.equal(exported[n], want[n]), n
