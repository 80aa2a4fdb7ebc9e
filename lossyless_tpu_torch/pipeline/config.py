"""Experiment configuration: dataclass tree + dotted overrides + presets.

Counterpart of `lossyless_tpu/pipeline/config.py`: `DataConfig`,
`TrainerConfig`, `ExperimentConfig`, `apply_overrides` (the `a.b.c=value`
override syntax, literal-eval coercion), `apply_precision` and the presets
that run on the port: the banana experiments `banana_viz_VIC`,
`banana_viz_VAE`, `banana_viz_BINCE`, `banana_viz_VIC_trnslt` and
`banana_RD` (fp32), the augmented-MNIST experiments `mnist_vic` (alias
`augmnist_viz_VIC`; a ResNet-18 encoder, the hyperprior rate, the CNN
decoder), `augmnist_RD`, the staggered `mnist_stag_step1` /
`mnist_stag_step2` and the augmentation study `augmnist_aug` /
`augmnist_aug_warm`, the STL10 experiments `stl10_bince` (the
contrastive distortion on the ResNet), `stl10_understand_VIC` and its
variants `stl10_action_dist_shift`, `stl10_rate_variation` (the
factorized rate) and `stl10_dist_variation`, and `stl10_balle` (BALLE
with the spatial hyperprior), the CLIP recipes
`clip_bottleneck_pretrain` (the hyperprior rate), `clip_hub` (the
factorized rate), `clip_lossyZ` (the hyperprior bottleneck with the
online probe) and its evaluation presets
`clip_bottleneck_{linear,mlp}_eval` and `clip_raw_{linear,mlp}_eval`
(the lossless rate, featurizer at init), and the SSL recipes
`ssl_bottleneck_pretrain` (the bottleneck on CLIP's RN50, or with
`encoder.arch=simclr|swav` a ResNet-50, loaded from
`encoder.pretrained_path`) and its `ssl_bottleneck_{linear,mlp}_eval`.
`galaxy_regression` waits for ROADMAP queue 1 item 10 (order 9).
"""

from __future__ import annotations

import ast
import copy
import dataclasses
from dataclasses import field
from pathlib import Path
from typing import Any

from ..compressors.compressor import (CompressorConfig, EncoderConfig,
                                      LossConfig, OnlineEvalConfig)
from ..compressors.distortions import DistortionConfig
from ..compressors.rates import RateConfig
from ..train.state import OptimConfig
from .predictor import PredictorConfig


@dataclasses.dataclass
class DataConfig:
    name: str = "banana"
    batch_size: int = 1024
    val_batch_size: int = 2048
    n_epochs: int = 10
    kwargs: dict = field(default_factory=dict)   # forwarded to the dataset


@dataclasses.dataclass
class TrainerConfig:
    seed: int = 123
    log_every: int = 100
    ckpt_every_epochs: int = 1
    monitor: str = "loss"
    monitor_mode: str = "min"
    limit_train_batches: float = 1.0   # dev-mode caps (config/mode/dev.yaml)
    limit_eval_batches: float = 1.0
    # train each epoch on batches drawn on the device when the dataset has
    # a device sampler (train/state.py::make_generative_epoch)
    use_fused_epochs: bool = True
    # data-parallel ranks for training (pipeline/run.py::_training_mesh):
    # 1, N (spawned, or torchrun's group of N), 0 = every visible device
    n_devices: int = 1
    # training metrics sink: csv | wandb | none (train/loggers.py)
    logger: str = "csv"
    # compute precision for encoder/decoder bodies: fp32 | bf16 (fp32
    # params and norm statistics either way; the entropy-model likelihoods
    # and the rate affine stay fp32)
    precision: str = "fp32"


@dataclasses.dataclass
class ExperimentConfig:
    experiment: str = "dev"
    stage: str = "featurizer"
    out_dir: str = "results"
    ckpt_dir: str = "checkpoints"
    is_only_feat: bool = False
    is_skip_comm: bool = False

    data_feat: DataConfig = field(default_factory=DataConfig)
    data_pred: DataConfig | None = None          # defaults to data_feat

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    rate: RateConfig = field(default_factory=RateConfig)
    distortion: DistortionConfig = field(default_factory=DistortionConfig)
    online: OnlineEvalConfig = field(default_factory=OnlineEvalConfig)
    loss: LossConfig = field(default_factory=LossConfig)

    # the reference's global optimizer defaults (config/main.yaml:17-22):
    # AdamW lr 1e-3 (featurizer) / 3e-4 (coder, online), weight decay 1e-5,
    # exponential lr decay by 100x over training (scheduler expdecay100);
    # presets/CLI override per recipe. total_steps=0 -> span the planned
    # training (bound at dataset-bind time, run.py).
    optimizer_feat: OptimConfig = field(
        default_factory=lambda: OptimConfig(mode="adamw", lr=1e-3,
                                            weight_decay=1e-5,
                                            scheduler="expdecay",
                                            decay_factor=100.,
                                            total_steps=0))
    optimizer_coder: OptimConfig = field(
        default_factory=lambda: OptimConfig(mode="adamw", lr=3e-4,
                                            weight_decay=1e-5,
                                            scheduler="expdecay",
                                            decay_factor=100.,
                                            total_steps=0))
    optimizer_online: OptimConfig = field(
        default_factory=lambda: OptimConfig(mode="adamw", lr=3e-4,
                                            weight_decay=1e-5,
                                            scheduler="expdecay",
                                            decay_factor=100.,
                                            total_steps=0))

    predictor: PredictorConfig = field(default_factory=PredictorConfig)

    trainer: TrainerConfig = field(default_factory=TrainerConfig)

    # parameter-subtree names receiving zero updates — the reference's
    # Freezer callback (callbacks.py:503-531) for staggered training, e.g.
    # ("p_ZlX",) freezes the encoder in a stag_step2 run
    frozen: tuple = ()

    # filled from the dataset at runtime (main.py:346-373)
    in_shape: Any = None
    target_shape: Any = None
    aux_shape: Any = None

    def compressor_config(self) -> CompressorConfig:
        return CompressorConfig(
            encoder=self.encoder, rate=self.rate, distortion=self.distortion,
            online=self.online, loss=self.loss, in_shape=self.in_shape,
            target_shape=self.target_shape, aux_shape=self.aux_shape)

    @property
    def long_name(self) -> str:
        """Path segment encoding the config (config/main.yaml:47-49 scheme)."""
        return "/".join([
            f"exp_{self.experiment}",
            f"datafeat_{self.data_feat.name}",
            f"dist_{self.distortion.mode}",
            f"enc_{self.encoder.arch}",
            f"rate_{self.rate.mode}",
            f"zdim_{self.encoder.z_dim}",
            f"beta_{self.loss.beta:.1e}",
            f"seed_{self.trainer.seed}",
        ])

    @property
    def stage_dir(self) -> Path:
        return Path(self.out_dir) / self.long_name


# architectures whose modules accept a dtype= compute-precision kwarg
_DTYPE_ARCHS = {"mlp", "cnn", "balle", "resnet", "clip", "clip_vit",
                "clip_rn50", "simclr", "swav"}


def apply_precision(cfg: ExperimentConfig) -> ExperimentConfig:
    """Resolve trainer.precision into arch dtype kwargs (idempotent).

    bf16 is injected into the encoder and distortion-decoder arch kwargs
    (probes stay fp32 — they are tiny and their CE/acc metrics are the
    product). An explicit arch_kwargs.dtype always wins.
    """
    if cfg.trainer.precision in ("fp32", "float32", "32", None):
        return cfg
    if cfg.trainer.precision not in ("bf16", "bfloat16", "16"):
        raise ValueError(
            f"trainer.precision={cfg.trainer.precision!r}: use fp32 or bf16")

    def with_dtype(kw):
        kw = dict(kw)
        kw.setdefault("dtype", "bfloat16")
        return kw

    if cfg.encoder.arch in _DTYPE_ARCHS:
        cfg.encoder = dataclasses.replace(
            cfg.encoder, arch_kwargs=with_dtype(cfg.encoder.arch_kwargs))
    # arch=None resolves to cnn/mlp decoders inside the estimator — all
    # dtype-capable for the direct mode
    if cfg.distortion.arch in _DTYPE_ARCHS or (
            cfg.distortion.arch is None and cfg.distortion.mode == "direct"):
        cfg.distortion = dataclasses.replace(
            cfg.distortion,
            arch_kwargs=with_dtype(cfg.distortion.arch_kwargs))
    return cfg


# ---------------------------------------------------------------------------
# Overrides
# ---------------------------------------------------------------------------


def _coerce(value: str):
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def apply_overrides(cfg: ExperimentConfig, overrides: list[str]) -> ExperimentConfig:
    """Apply `a.b.c=value` assignments; frozen dataclasses are rebuilt."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, value = ov.split("=", 1)
        parts = key.split(".")
        if parts[0] == "data_pred" and len(parts) > 1 and cfg.data_pred is None:
            # reference begin() (main.py:246-251): data_pred defaults to
            # data_feat and overrides are merged on top of that copy
            cfg.data_pred = copy.deepcopy(cfg.data_feat)
        _set_path(cfg, parts, _coerce(value))
    return cfg


def _set_path(obj, parts: list[str], value):
    head, rest = parts[0], parts[1:]
    if not rest:
        _set_attr(obj, head, value)
        return
    child = _get_attr(obj, head)
    if dataclasses.is_dataclass(child) and _is_frozen(child):
        # rebuild the frozen child with the nested assignment applied
        _set_attr(obj, head, _rebuild_frozen(child, rest, value))
    else:
        _set_path(child, rest, value)


def _rebuild_frozen(child, parts, value):
    kw = {f.name: getattr(child, f.name) for f in dataclasses.fields(child)}
    head, rest = parts[0], parts[1:]
    if not rest:
        if head not in kw:
            raise AttributeError(
                f"{type(child).__name__} has no field {head!r}")
        kw[head] = value
    else:
        inner = kw[head]
        if dataclasses.is_dataclass(inner) and _is_frozen(inner):
            kw[head] = _rebuild_frozen(inner, rest, value)
        elif isinstance(inner, dict):
            inner = dict(inner)
            _set_dict_path(inner, rest, value)
            kw[head] = inner
        else:
            _set_path(inner, rest, value)
    return type(child)(**kw)


def _set_dict_path(d: dict, parts, value):
    if len(parts) == 1:
        d[parts[0]] = value
    else:
        _set_dict_path(d.setdefault(parts[0], {}), parts[1:], value)


def _is_frozen(obj) -> bool:
    return getattr(type(obj), "__dataclass_params__").frozen


def _get_attr(obj, name):
    if isinstance(obj, dict):
        return obj[name]
    if not hasattr(obj, name):
        raise AttributeError(f"{type(obj).__name__} has no field {name!r}")
    return getattr(obj, name)


def _set_attr(obj, name, value):
    if isinstance(obj, dict):
        obj[name] = value
        return
    if not hasattr(obj, name):
        raise AttributeError(f"{type(obj).__name__} has no field {name!r}")
    if dataclasses.is_dataclass(obj) and _is_frozen(obj):
        raise AttributeError(
            f"cannot set {name} on frozen {type(obj).__name__} directly")
    setattr(obj, name, value)


# ---------------------------------------------------------------------------
# Presets (the reference's experiment groups)
# ---------------------------------------------------------------------------


def preset(name: str) -> ExperimentConfig:
    cfg = _preset_impl(name)
    # the reference trains in half precision except for the banana
    # recipes, as the JAX package's presets do (bf16); overrides applied
    # after preset() still win
    if not cfg.experiment.startswith("banana") and \
            cfg.trainer.precision == "fp32":
        cfg.trainer = dataclasses.replace(cfg.trainer, precision="bf16")
    return cfg


def _preset_impl(name: str) -> ExperimentConfig:
    if name in ("banana_viz_VIC", "banana_vic"):
        # bin/banana/banana_viz_VIC.sh + config/data/base_banana.yaml: 100
        # epochs x 1000 steps of batch 1024 (length=1024000), lr 3e-4 with
        # exponential decay /1000 (featurizer) and /100 (coder)
        return ExperimentConfig(
            experiment="banana_viz_VIC",
            data_feat=DataConfig(name="banana", batch_size=1024, n_epochs=100,
                                 kwargs=dict(additional_target="representative",
                                             length=1024000)),
            optimizer_feat=OptimConfig(lr=3e-4, scheduler="expdecay",
                                       decay_factor=1000., total_steps=0),
            optimizer_coder=OptimConfig(lr=3e-4, scheduler="expdecay",
                                        decay_factor=100., total_steps=0),
            encoder=EncoderConfig(
                arch="mlp", z_dim=2, family="deterministic",
                arch_kwargs=dict(hid_dim=1024, n_hid_layers=2,
                                 norm_layer="batchnorm",
                                 activation="quickgelu")),
            rate=RateConfig(mode="H_factorized"),
            distortion=DistortionConfig(
                mode="direct", data_mode="distribution",
                is_classification=False,
                arch_kwargs=dict(hid_dim=1024, n_hid_layers=2,
                                 norm_layer="batchnorm",
                                 activation="quickgelu")),
            online=OnlineEvalConfig(is_online=True, is_classification=False,
                                    arch_kwargs=dict(hid_dim=512)),
            loss=LossConfig(beta=0.07, beta_anneal="constant"),
            predictor=PredictorConfig(is_classification=False),
        )
    if name in ("banana_viz_VAE", "banana_vae"):
        # the script pins distortion.factor_beta=1 over VAE.yaml's 0.5
        # (bin/banana/banana_viz_VIC.sh:21)
        cfg = preset("banana_viz_VIC")
        cfg.experiment = "banana_viz_VAE"
        cfg.data_feat.kwargs["additional_target"] = "input"
        return cfg
    if name in ("banana_viz_BINCE", "banana_bince"):
        # bin/banana/banana_viz_BINCE.sh: the contrastive distortion with a
        # 1-d latent, the contrastive defaults (trainable temperature 0.01,
        # cosine logits), no effective-batch-size reweighting, beta 0.6
        cfg = preset("banana_viz_VIC")
        cfg.experiment = "banana_viz_BINCE"
        cfg.data_feat.kwargs["additional_target"] = "equiv_x"
        cfg.encoder = dataclasses.replace(cfg.encoder, z_dim=1)
        cfg.distortion = DistortionConfig(mode="contrastive", project_dim=1,
                                          effective_batch_size=None)
        cfg.loss = dataclasses.replace(cfg.loss, beta=0.6)
        return cfg
    if name in ("banana_viz_VIC_trnslt",):
        # bin/banana/banana_viz_VIC_trnslt.sh: translation equivalence
        cfg = preset("banana_viz_VIC")
        cfg.experiment = "banana_viz_VIC_trnslt"
        cfg.data_feat.kwargs["equivalence"] = "y_translation"
        return cfg
    if name in ("banana_RD",):
        # bin/banana/banana_RD.sh: the beta-sweep base over the rotated
        # banana (sweep loss.beta with the CLI's -m)
        cfg = preset("banana_viz_VIC")
        cfg.experiment = "banana_RD"
        return cfg
    if name in ("mnist_vic", "augmnist_viz_VIC"):
        # bin/mnist/augmnist_viz_VIC.sh: resnet18 encoder, H_hyper rate,
        # z=128, beta=0.1, 100 epochs on augmented MNIST (the mnist spec's
        # default equivalence: x/y translation, rotation, scale, shear);
        # the featurizer reconstructs the image (the CNN decoder)
        return ExperimentConfig(
            experiment="augmnist_viz_VIC",
            data_feat=DataConfig(name="mnist", batch_size=256, n_epochs=100,
                                 kwargs=dict(
                                     additional_target="representative")),
            encoder=EncoderConfig(arch="resnet", z_dim=128),
            rate=RateConfig(mode="H_hyper"),
            distortion=DistortionConfig(mode="direct", data_mode="image",
                                        arch_kwargs=dict(hid_dim=32)),
            online=OnlineEvalConfig(is_online=True, is_classification=True,
                                    arch_kwargs=dict(hid_dim=512)),
            loss=LossConfig(beta=0.1),
        )
    if name in ("augmnist_RD", "mnist_RD"):
        # bin/mnist/augmnist_RD.sh: the beta-sweep base config
        cfg = preset("mnist_vic")
        cfg.experiment = "augmnist_RD"
        return cfg
    if name in ("mnist_stag_step1", "augmnist_stag_step1"):
        # bin/mnist/augmnist_stag_step1.sh: train the encoder with no
        # learned rate (lossless, beta 1), export it for step 2
        cfg = preset("mnist_vic")
        cfg.experiment = "augmnist_stag"
        cfg.is_only_feat = True
        cfg.rate = RateConfig(mode="lossless")
        cfg.loss = dataclasses.replace(cfg.loss, beta=1.0)
        return cfg
    if name in ("mnist_stag_step2", "augmnist_stag_step2"):
        # bin/mnist/augmnist_stag_step2.sh: the frozen step-1 encoder
        # (encoder.pretrained_path names step 1's export), the H_hyper
        # rate on a detached encoder, lossy_Z, beta 1e-2, 50 epochs
        cfg = preset("mnist_vic")
        cfg.experiment = "augmnist_stag"
        cfg.frozen = ("p_ZlX",)
        cfg.rate = RateConfig(mode="H_hyper", is_endToEnd=False)
        cfg.distortion = DistortionConfig(mode="lossy_Z")
        cfg.data_feat = dataclasses.replace(cfg.data_feat, n_epochs=50)
        cfg.loss = dataclasses.replace(cfg.loss, beta=1e-2)
        return cfg
    if name in ("augmnist_aug", "augmnist_aug_warm"):
        # bin/mnist/augmnist_aug{,_warm}.sh: the augmentation study, the
        # probe on augmented MNIST; _warm trains the rate on a detached
        # encoder for its first 5 epochs (rate.warmup_k_epochs)
        cfg = preset("mnist_vic")
        cfg.experiment = name
        cfg.encoder = EncoderConfig(arch="resnet", z_dim=128)
        cfg.data_feat = dataclasses.replace(cfg.data_feat, n_epochs=100)
        cfg.data_pred = DataConfig(name="mnist", batch_size=256, kwargs=dict(
            additional_target="representative"))
        cfg.loss = dataclasses.replace(cfg.loss, beta_anneal="constant")
        if name.endswith("_warm"):
            cfg.rate = dataclasses.replace(cfg.rate, warmup_k_epochs=5)
        return cfg
    if name in ("stl10_bince",):
        # bin/stl10: the contrastive (BINCE) featurizer on augmented STL10
        # (the default STL10 equivalence), resnet18, z=128, the factorized
        # rate, project_dim 128, beta 0.01
        return ExperimentConfig(
            experiment="stl10_bince",
            data_feat=DataConfig(name="stl10", batch_size=256, n_epochs=20,
                                 kwargs=dict(additional_target="equiv_x")),
            encoder=EncoderConfig(arch="resnet", z_dim=128),
            rate=RateConfig(mode="H_factorized"),
            distortion=DistortionConfig(mode="contrastive", project_dim=128),
            online=OnlineEvalConfig(is_online=True,
                                    arch_kwargs=dict(hid_dim=512)),
            loss=LossConfig(beta=0.01),
        )
    if name in ("stl10_balle",):
        # bin/stl10/STL10_balle.sh: the BALLE conv autoencoder with the
        # spatial hyperprior, z=8192 (96 px resized to 128, 4 stride-2
        # convs: 8x8 positions x 128 channels), on the unlabeled images;
        # the probe on labeled STL10; the online probe off (the script's
        # evaluation.featurizer.is_online=false); beta 1e-3, the largest
        # point of the script's sweep
        return ExperimentConfig(
            experiment="stl10_balle",
            data_feat=DataConfig(name="stl10_unlabeled", batch_size=64,
                                 n_epochs=100,
                                 kwargs=dict(additional_target="input")),
            data_pred=DataConfig(name="stl10", batch_size=64),
            encoder=EncoderConfig(arch="balle", z_dim=8192,
                                  arch_kwargs=dict(hid_dim=64)),
            rate=RateConfig(mode="H_spatial", n_channels=128),
            distortion=DistortionConfig(mode="direct", data_mode="image",
                                        arch="balle",
                                        arch_kwargs=dict(hid_dim=64)),
            online=OnlineEvalConfig(is_online=False),
            loss=LossConfig(beta=1e-3),
        )
    if name in ("stl10_rate_variation",):
        # bin/stl10/STL10_rate_variation.sh: stl10_understand_VIC with the
        # factorized rate (the script sweeps rate.mode on the CLI)
        cfg = preset("stl10_understand_VIC")
        cfg.experiment = "stl10_rate_variation"
        cfg.rate = RateConfig(mode="H_factorized")
        return cfg
    if name in ("stl10_dist_variation",):
        # bin/stl10/STL10_dist_variation_{featpred,recpred}.sh: resnet18 +
        # H_hyper on unlabeled STL10 (the script sweeps the distortion)
        cfg = preset("stl10_understand_VIC")
        cfg.experiment = "stl10_dist_variation"
        return cfg
    if name in ("stl10_action_dist_shift", "stl10_understand_VIC"):
        # bin/stl10/STL10_action_dist_shift.sh / STL10_understand_VIC.sh:
        # the featurizer on unlabeled STL10 reconstructing the image (the
        # CNN decoder at hid_dim 64), H_hyper, the probe on labeled STL10
        return ExperimentConfig(
            experiment=name,
            data_feat=DataConfig(name="stl10_unlabeled", batch_size=256,
                                 n_epochs=100, kwargs=dict(
                                     additional_target="representative")),
            data_pred=DataConfig(name="stl10", batch_size=256),
            encoder=EncoderConfig(arch="resnet", z_dim=128),
            rate=RateConfig(mode="H_hyper"),
            distortion=DistortionConfig(mode="direct", data_mode="image",
                                        arch_kwargs=dict(hid_dim=64)),
            online=OnlineEvalConfig(is_online=True,
                                    arch_kwargs=dict(hid_dim=512)),
            loss=LossConfig(beta=0.1),
        )
    if name in ("clip_bottleneck_pretrain",):
        # bin/clip/clip_bottleneck_pretrain.sh: pretrain the CLIP
        # bottleneck on COCO — featurizer=bottleneck_clip_lossyZ (frozen
        # tower, lossy_Z, H_hyper rate, beta 5e-2, featurizer only)
        return ExperimentConfig(
            experiment="clip_bottleneck_pretrain",
            is_only_feat=True,
            data_feat=DataConfig(name="coco_clip", batch_size=128,
                                 n_epochs=30, kwargs=dict()),
            encoder=EncoderConfig(arch="clip", z_dim=512),
            rate=RateConfig(mode="H_hyper", is_endToEnd=False),
            distortion=DistortionConfig(mode="lossy_Z"),
            online=OnlineEvalConfig(is_online=False),
            loss=LossConfig(beta=0.05),
            frozen=("p_ZlX",),
            optimizer_feat=OptimConfig(mode="adamw", lr=1e-3,
                                       weight_decay=3e-8,
                                       scheduler="unifmultistep",
                                       decay_factor=1000., total_steps=0),
            optimizer_coder=OptimConfig(mode="adamw", lr=3e-4,
                                        weight_decay=1e-6,
                                        scheduler="unifmultistep",
                                        decay_factor=1000., total_steps=0),
        )
    if name in ("clip_hub",):
        # bin/clip/clip_hub.sh: train the three hub betas on COCO with
        # featurizer=bottleneck_clip_lossyZ_factorized — same recipe but
        # the FACTORIZED rate, whose EB state dict becomes the published
        # hub/beta*/factorized_rate.pt (sweep loss.beta over
        # {1e-2, 5e-2, 1e-1} on the CLI; export via hub.save_hub)
        cfg = preset("clip_bottleneck_pretrain")
        cfg.experiment = "clip_hub"
        cfg.rate = RateConfig(mode="H_factorized", eb_filters=(3, 3, 3, 3),
                              is_endToEnd=False)
        return cfg
    if name in ("ssl_bottleneck_pretrain",):
        # bin/ssl/bottleneck_pretrain.sh: the same bottleneck on an SSL
        # ResNet-50 tower (encoder.arch=clip_rn50|simclr|swav); CLIP RN50's
        # attention pool gives 1024-d embeddings, simclr/swav pool to 2048
        # (override z_dim with the arch); the hyperprior rate
        cfg = preset("clip_bottleneck_pretrain")
        cfg.experiment = "ssl_bottleneck_pretrain"
        cfg.encoder = EncoderConfig(arch="clip_rn50", z_dim=1024)
        cfg.rate = RateConfig(mode="H_hyper", is_endToEnd=False)
        cfg.loss = dataclasses.replace(cfg.loss, beta=1e-3)
        return cfg
    if name in ("ssl_bottleneck_linear_eval",):
        # bin/ssl/bottleneck_linear_eval.sh: a linear probe on the
        # compressed SSL (ResNet-50) features
        cfg = preset("ssl_bottleneck_pretrain")
        cfg.experiment = "ssl_bottleneck_linear_eval"
        cfg.is_only_feat = False
        cfg.predictor = PredictorConfig(arch="linear", arch_kwargs={},
                                        n_epochs=20)
        return cfg
    if name in ("ssl_bottleneck_mlp_eval",):
        # bin/ssl/bottleneck_mlp_eval.sh
        cfg = preset("ssl_bottleneck_linear_eval")
        cfg.experiment = "ssl_bottleneck_mlp_eval"
        cfg.predictor = PredictorConfig()
        return cfg
    if name in ("clip_lossyZ", "clip_bottleneck"):
        # bottleneck_clip_lossyZ: frozen CLIP tower, hyperprior rate on the
        # 512-d embeddings, lossy_Z distortion, beta 5e-2, the online probe
        return ExperimentConfig(
            experiment="clip_lossyZ",
            data_feat=DataConfig(name="stl10", batch_size=128, n_epochs=10,
                                 kwargs=dict(additional_target="target")),
            encoder=EncoderConfig(arch="clip", z_dim=512),
            rate=RateConfig(mode="H_hyper", is_endToEnd=False),
            distortion=DistortionConfig(mode="lossy_Z"),
            online=OnlineEvalConfig(is_online=True,
                                    arch_kwargs=dict(hid_dim=512)),
            loss=LossConfig(beta=0.05),
            frozen=("p_ZlX",),
            optimizer_feat=OptimConfig(mode="adamw", lr=1e-3,
                                       weight_decay=3e-8,
                                       scheduler="unifmultistep",
                                       decay_factor=1000., total_steps=0),
            optimizer_coder=OptimConfig(mode="adamw", lr=3e-4,
                                        weight_decay=1e-6,
                                        scheduler="unifmultistep",
                                        decay_factor=1000., total_steps=0),
        )
    if name in ("clip_bottleneck_linear_eval",):
        # bin/clip/clip_bottleneck_linear_eval.sh: a linear probe on the
        # frozen compressed features (data_pred.name picks the dataset)
        cfg = preset("clip_lossyZ")
        cfg.experiment = "clip_bottleneck_linear_eval"
        cfg.predictor = PredictorConfig(arch="linear", arch_kwargs={},
                                        n_epochs=20)
        return cfg
    if name in ("clip_bottleneck_mlp_eval",):
        cfg = preset("clip_bottleneck_linear_eval")
        cfg.experiment = "clip_bottleneck_mlp_eval"
        cfg.predictor = PredictorConfig()  # the default 2048-wide MLP probe
        return cfg
    if name in ("clip_raw_linear_eval",):
        # bin/clip/clip_raw_linear_eval.sh: raw frozen CLIP features, the
        # lossless rate, featurizer kept at init (n_epochs=0)
        cfg = preset("clip_bottleneck_linear_eval")
        cfg.experiment = "clip_raw_linear_eval"
        cfg.rate = RateConfig(mode="lossless")
        cfg.data_feat = dataclasses.replace(cfg.data_feat, n_epochs=0)
        return cfg
    if name in ("clip_raw_mlp_eval",):
        cfg = preset("clip_raw_linear_eval")
        cfg.experiment = "clip_raw_mlp_eval"
        cfg.predictor = PredictorConfig()
        return cfg
    raise NotImplementedError(
        f"preset {name!r} is not ported yet (ROADMAP queue 1 item 10)")


def available_presets() -> list[str]:
    """The presets this package has, in the JAX package's order:
    `clip_hub`, `clip_bottleneck_pretrain` and `ssl_bottleneck_pretrain`
    (COCO recipes, featurizer only) train through
    `pipeline.run.run_featurizer` and code through `run_communication`;
    the others run the three stages through `pipeline.run.main`."""
    return ["banana_viz_VIC", "banana_viz_VAE", "banana_viz_BINCE",
            "banana_viz_VIC_trnslt", "banana_RD", "mnist_vic", "augmnist_RD",
            "augmnist_aug", "augmnist_aug_warm",
            "mnist_stag_step1", "mnist_stag_step2", "stl10_bince",
            "stl10_balle", "stl10_rate_variation", "stl10_dist_variation",
            "stl10_action_dist_shift", "stl10_understand_VIC",
            "clip_lossyZ", "clip_bottleneck_pretrain", "clip_hub",
            "ssl_bottleneck_pretrain", "ssl_bottleneck_linear_eval",
            "ssl_bottleneck_mlp_eval", "clip_bottleneck_linear_eval",
            "clip_bottleneck_mlp_eval", "clip_raw_linear_eval",
            "clip_raw_mlp_eval"]
