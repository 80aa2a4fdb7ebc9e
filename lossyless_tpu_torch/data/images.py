"""Image datasets with equivalence augmentation.

Counterpart of `lossyless_tpu/data/images.py`: `SPECS`, the seeded
procedural source `_synthetic` (the same bytes as JAX's for every split
and seed), `ImageDataset` (load, carve train/validation from train,
`batches` with `drop_last`, `is_normalize`, the equivalence's
augmentations and the joint (image, label) `label_equivalence`,
`device_sampler`), the file loaders (MNIST's idx files, CIFAR-10/100's
pickles, STL10's binary format, `load_image_folder` for the ingested
class-per-subdirectory sets) and `get_datamodule`, which also routes
`imagenet`, `coco_clip` / `coco_captions` and `galaxy_zoo` to
`data/external.py`.

Batches are `(x, target, aux_target)` CPU tensors: x float32 NHWC in
[0, 1] (normalized with `is_normalize`), in the order of JAX's batches
(one `default_rng(seed)` permutation an epoch), augmented with
`is_augment` by the equivalence's chain and then, with a
`label_equivalence`, by `EquivariantRandomResizedCrop` (which may
resample the label), all drawn from a `torch.Generator` seeded with the
epoch's seed. `aux_target` follows `additional_target` (`input`: the
augmented x; `representative`: the raw image; `equiv_x`: a second view
augmented by the chain alone, normalized as x is; `target`: the label).
`device_sampler` draws, augments and builds the same triple on the card;
`ImageDataset.build` turns given draws into a batch, so a test can hand
both paths JAX's draws.

Real files are read under `DATA_DIR` only when `synthetic` is off: a
missing file raises, it never falls back to the synthetic source.
"""

from __future__ import annotations

import dataclasses
import gzip
import pickle
import zlib
from pathlib import Path
from typing import ClassVar, Sequence

import numpy as np
import torch

from ..core import mesh
from .augmentations import make_augmenter
from .label_augment import EquivariantRandomResizedCrop
from .norms import MEANS, STDS

# where the real datasets go once they are in the repository
DATA_DIR = Path(__file__).resolve().parents[2] / "data"

@dataclasses.dataclass
class ImageSpec:
    name: str
    shape: tuple            # (H, W, C)
    n_classes: int
    default_equivalence: tuple = ()


SPECS = {
    "mnist": ImageSpec("mnist", (32, 32, 1), 10,
                       ("x_translation", "y_translation", "rotation", "scale",
                        "shear")),
    "cifar10": ImageSpec("cifar10", (32, 32, 3), 10,
                         ("hflip", "resize_crop", "color", "gray")),
    "cifar100": ImageSpec("cifar100", (32, 32, 3), 100,
                          ("hflip", "resize_crop", "color", "gray")),
    "stl10": ImageSpec("stl10", (96, 96, 3), 10,
                       ("hflip", "resize_crop", "color", "gray")),
    "galaxy": ImageSpec("galaxy", (64, 64, 3), 37, ("D4_group",)),
    "food101": ImageSpec("food101", (96, 96, 3), 101,
                         ("hflip", "resize_crop", "color", "gray")),
    "cars196": ImageSpec("cars196", (96, 96, 3), 196,
                         ("hflip", "resize_crop", "color", "gray")),
    "pcam": ImageSpec("pcam", (96, 96, 3), 2, ("D4_group",)),
    "pets37": ImageSpec("pets37", (96, 96, 3), 37,
                        ("hflip", "resize_crop", "color", "gray")),
    "caltech101": ImageSpec("caltech101", (96, 96, 3), 101,
                            ("hflip", "resize_crop", "color", "gray")),
}

def _load_mnist(data_dir: Path, split: str):
    """MNIST's gzip'd idx files under `data_dir/MNIST/raw`, each 28 x 28
    digit resized to 32 x 32 with PIL's bicubic filter (JAX's loader, the
    reference's `Resize(32, BICUBIC)`): (N, 32, 32, 1) uint8, int64
    labels."""
    from PIL import Image

    name = "train" if split == "train" else "t10k"
    raw = data_dir / "MNIST" / "raw"
    with gzip.open(raw / f"{name}-images-idx3-ubyte.gz") as f:
        data = np.frombuffer(f.read(), np.uint8, offset=16).reshape(
            -1, 28, 28)
    with gzip.open(raw / f"{name}-labels-idx1-ubyte.gz") as f:
        labels = np.frombuffer(f.read(), np.uint8, offset=8)
    data = np.stack([
        np.asarray(Image.fromarray(img).resize((32, 32), Image.BICUBIC))
        for img in data])[..., None]
    return data, labels.astype(np.int64)


def _load_cifar(data_dir: Path, split: str, n100: bool = False):
    """CIFAR-10's or CIFAR-100's python pickles under `data_dir`
    (`cifar-10-batches-py/`, `cifar-100-python/`; CIFAR-100's fine
    labels): (N, 32, 32, 3) uint8, int64 labels."""
    if not n100:
        base = data_dir / "cifar-10-batches-py"
        files = ([base / f"data_batch_{i}" for i in range(1, 6)]
                 if split == "train" else [base / "test_batch"])
        xs, ys = [], []
        for f in files:
            with open(f, "rb") as fh:
                d = pickle.load(fh, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        data = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return data, np.asarray(ys, np.int64)
    f = data_dir / "cifar-100-python" / ("train" if split == "train"
                                         else "test")
    with open(f, "rb") as fh:
        d = pickle.load(fh, encoding="bytes")
    data = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return data, np.asarray(d[b"fine_labels"], np.int64)


def _load_stl10(data_dir: Path, split: str):
    base = data_dir / "stl10_binary"
    xf = base / f"{split}_X.bin"
    yf = base / f"{split}_y.bin"
    data = np.fromfile(xf, np.uint8).reshape(-1, 3, 96, 96).transpose(
        0, 3, 2, 1)
    if yf.exists():
        labels = np.fromfile(yf, np.uint8).astype(np.int64) - 1
    else:
        labels = np.full(len(data), -1, np.int64)  # unlabeled split
    return data, labels


def load_image_folder(root: Path, size: tuple[int, int],
                      extensions=(".jpg", ".jpeg", ".png")) -> tuple:
    """A class-per-subdirectory image folder (`root/<class>/<image>`, the
    layout `data.ingest.ingest_tfds` writes) as (uint8 (N, H, W, 3)
    decoded and resized to `size` by `data.loader`'s thread pool, int64
    labels, class names); classes and files in sorted order."""
    from .loader import decode_image_batch

    root = Path(root)
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {root}")
    paths, labels = [], []
    for ci, cname in enumerate(classes):
        for f in sorted((root / cname).iterdir()):
            if f.suffix.lower() in extensions:
                paths.append(f)
                labels.append(ci)
    if not paths:
        raise FileNotFoundError(f"no images under {root}")
    return (decode_image_batch(paths, size), np.asarray(labels, np.int64),
            classes)


def _synthetic(spec: ImageSpec, split: str, n: int, seed: int):
    """Procedural class-structured images: class-dependent frequency gratings
    plus noise — linearly separable enough for pipeline validation."""
    rng = np.random.default_rng(seed + (0 if split == "train" else 1))
    h, w, c = spec.shape
    labels = rng.integers(0, spec.n_classes, n)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    imgs = np.empty((n, h, w, c), np.uint8)
    for cls in range(spec.n_classes):
        idx = np.where(labels == cls)[0]
        if len(idx) == 0:
            continue
        freq = 1 + cls % 7
        phase = (cls // 7) * 0.7
        base = 0.5 + 0.4 * np.sin(2 * np.pi * freq * xx / w + phase) \
            * np.cos(2 * np.pi * freq * yy / h)
        noise = rng.normal(0, 0.08, (len(idx), h, w, c))
        img = np.clip(base[None, :, :, None] + noise, 0, 1)
        imgs[idx] = (img * 255).astype(np.uint8)
    if split == "unlabeled":  # match the real loader's -1 targets
        labels = np.full(n, -1)
    return imgs, labels.astype(np.int64)


@dataclasses.dataclass
class ImageDataset:
    """In-memory uint8 image dataset (JAX's fields and defaults)."""

    name: str = "mnist"
    split: str = "train"
    # underlying split of "train": "unlabeled" trains on STL10's unlabeled
    # images (targets -1), validation carved from it, test stays labeled
    train_split: str | None = None
    equivalence: Sequence[str] | None = None
    additional_target: str | None = "representative"
    is_normalize: bool = False
    is_augment: bool = True           # augment x (train) or not (eval)
    label_equivalence: dict | None = None
    data_dir: Path = DATA_DIR
    synthetic: bool = False
    synthetic_n: int = 4096
    seed: int = 0
    # fraction of train carved off as the validation split
    val_fraction: float = 0.1

    # (name, train split, data root) -> the val_fraction of the first carve
    # in this process: a later carve of the same data with another
    # fraction would overlap one instance's train with another's validation
    _carve_fractions: ClassVar[dict] = {}

    def __post_init__(self):
        self.spec = SPECS[self.name]
        if self.equivalence is None:
            self.equivalence = self.spec.default_equivalence
        reg_key = (self.name, self.train_split or "train", str(self.data_dir))
        if self.split == "validation":
            try:  # native validation split
                if self.synthetic:
                    raise FileNotFoundError
                self.data, self.targets = self._load("validation")
            except FileNotFoundError:
                self.data, self.targets = self._carve("validation")
        elif self.split == "train" and self.val_fraction > 0:
            self.data, self.targets = self._carve("train")
        else:
            self.data, self.targets = self._load_any(
                (self.train_split or "train") if self.split == "train"
                else self.split)
            if self.split == "train":
                # a later validation carve of the same data must not
                # overlap this full-train instance
                ImageDataset._carve_fractions.setdefault(reg_key, 0.0)

    def _load(self, split: str):
        if self.name in ("mnist", "cifar10", "cifar100", "stl10"):
            if split == "validation":  # the binary formats: train/test only
                raise FileNotFoundError(
                    f"{self.name} has no validation split")
            if self.name == "mnist":
                return _load_mnist(self.data_dir, split)
            if self.name.startswith("cifar"):
                return _load_cifar(self.data_dir, split,
                                   n100=self.name == "cifar100")
            return _load_stl10(self.data_dir, split)
        # the ingested sets (food101, cars196, pcam, pets37, caltech101,
        # galaxy): class-per-subdir image folders under data_dir/name/split
        folder = Path(self.data_dir) / self.name / split
        if not folder.exists():
            raise FileNotFoundError(folder)
        h, w, _ = self.spec.shape
        data, targets, _ = load_image_folder(folder, (h, w))
        return data, targets

    def _load_any(self, split: str):
        if self.synthetic:
            return _synthetic(self.spec, split, self.synthetic_n, self.seed)
        return self._load(split)

    def _carve(self, which: str):
        """Split train into train/validation parts by a permutation seeded
        with the dataset's name, so instances built anywhere partition the
        same way provided they agree on val_fraction."""
        frac = self.val_fraction
        if frac <= 0:
            raise ValueError(
                f"{self.name}: a carved {which!r} split needs "
                f"val_fraction > 0 (got {frac})")
        data, targets = self._load_any(self.train_split or "train")
        reg_key = (self.name, self.train_split or "train", str(self.data_dir))
        seen = ImageDataset._carve_fractions.setdefault(reg_key, frac)
        if seen != frac:
            raise ValueError(
                f"{self.name}: val_fraction={frac} conflicts with "
                f"val_fraction={seen} used by an earlier instance on the "
                f"same data root — their train/validation splits would "
                f"overlap")
        n = len(data)
        n_val = max(1, int(round(n * frac)))
        perm = np.random.default_rng(
            zlib.crc32(self.name.encode())).permutation(n)
        idx = perm[:n_val] if which == "validation" else perm[n_val:]
        return data[idx], targets[idx]

    def __len__(self):
        return len(self.data)

    @property
    def shapes(self):
        return {"input": self.spec.shape, "target": (self.spec.n_classes,)}

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.is_normalize:
            return x
        # datasets without published statistics use CLIP's
        name = self.name if self.name in MEANS else "clip"
        mean, std = (torch.tensor(v[name], dtype=torch.float32,
                                  device=x.device) for v in (MEANS, STDS))
        return (x - mean) / std

    def augmenter(self):
        """The equivalence's chain when this dataset augments
        (`is_augment` with an equivalence set), else None."""
        if not self.is_augment or not self.equivalence:
            return None
        return make_augmenter(self.equivalence)

    def label_augmenter(self):
        """The joint (image, label) crop of `label_equivalence` when this
        dataset augments, else None."""
        if not self.is_augment or self.label_equivalence is None:
            return None
        return EquivariantRandomResizedCrop(
            num_classes=self.spec.n_classes, **self.label_equivalence)

    def draws(self, generator: torch.Generator, shape) -> tuple:
        """(x's, the label augmentation's, the equiv_x positive's) draws
        for a batch of `shape`, in that order, from `generator`; None
        where nothing is drawn."""
        augment, label_aug = self.augmenter(), self.label_augmenter()
        x_draw = None if augment is None else augment.draw(generator, shape)
        label_draw = None if label_aug is None \
            else label_aug.draw(generator, shape)
        aux_draw = None
        if augment is not None and self.additional_target == "equiv_x":
            aux_draw = augment.draw(generator, shape)
        return x_draw, label_draw, aux_draw

    def build(self, raw: torch.Tensor, y: torch.Tensor, x_draw=None,
              label_draw=None, aux_draw=None):
        """(x, y, aux) of the raw [0, 1] images and their labels: x
        augmented by the chain on `x_draw`, then jointly with y by the
        label augmentation on `label_draw`; an equiv_x positive by the
        chain on `aux_draw` (None: not augmented). Views that enter the
        encoder (x, equiv_x) are normalized; reconstruction targets stay
        in [0, 1]."""
        augment = self.augmenter()

        def view(draw):
            return raw if draw is None else augment.apply(raw, draw)

        x = view(x_draw)
        if label_draw is not None:
            x, y = self.label_augmenter().apply(x, y, label_draw)
        at = self.additional_target
        if at == "input":
            aux = x
        elif at == "representative":
            aux = raw
        elif at == "equiv_x":
            aux = self._normalize(view(aux_draw))
        elif at in ("target", None):
            aux = y
        else:
            raise ValueError(f"unknown additional_target={at}")
        return self._normalize(x), y, aux

    def batches(self, batch_size: int, n_epochs: int = 1, seed: int = 0,
                shuffle: bool = True, drop_last: bool = True):
        """Yield (x, target, aux_target) CPU tensors; the augmentations
        are drawn from a generator seeded with `seed` (`draws`)."""
        rng = np.random.default_rng(seed)
        g = torch.Generator().manual_seed(seed)
        n = len(self)
        for _ in range(n_epochs):
            order = rng.permutation(n) if shuffle else np.arange(n)
            stop = n - batch_size + 1 if drop_last else n
            for i in range(0, stop, batch_size):
                idx = order[i:i + batch_size]
                raw = torch.from_numpy(self.data[idx]).float() / 255.0
                y = torch.from_numpy(self.targets[idx])
                yield self.build(raw, y, *self.draws(g, raw.shape))

    def device_sampler(self, batch_size: int) -> "ImageSampler":
        """`sample(generator) -> (x, y, aux)`: a batch drawn, augmented
        and built on the generator's device (`ImageSampler`)."""
        return ImageSampler(self, batch_size)


class ImageSampler:
    """A dataset's batches drawn on the card (JAX's `device_sampler`).

    The uint8 images and the labels are staged on a device once, at the
    first call on it. Each call draws `batch_size` indices uniformly
    (with replacement), then the augmentations (`ImageDataset.draws`: x's
    chain, the label augmentation, an equiv_x positive's chain), all from
    the caller's generator on that device; `build` turns given draws into
    the batch, so a test can hand it JAX's. The normalization contract is
    `batches()`'s. In a data-parallel epoch (`core.mesh.data_parallel`)
    `batch_size` is a rank's rows: every draw is the global batch's, and
    the rank keeps its rows of each (`core.mesh.global_draw`)."""

    def __init__(self, ds: ImageDataset, batch_size: int):
        self.ds, self.batch_size = ds, batch_size
        self._staged = {}

    def _stage(self, device):
        key = str(torch.device(device))
        if key not in self._staged:
            self._staged[key] = (
                torch.as_tensor(self.ds.data).to(device),
                torch.as_tensor(self.ds.targets).to(device))
        return self._staged[key]

    def __call__(self, generator: torch.Generator):
        data, _ = self._stage(generator.device)
        idx = mesh.global_draw(lambda s: torch.randint(
            0, len(data), s, generator=generator, device=generator.device),
            (self.batch_size,))
        x_draw, label_draw, aux_draw = self.ds.draws(
            generator, (self.batch_size,) + tuple(data.shape[1:]))
        return self.build(idx, x_draw, aux_draw, label_draw)

    def build(self, idx: torch.Tensor, x_draw=None, aux_draw=None,
              label_draw=None):
        """The batch of images `idx` (`ImageDataset.build` on the given
        draws)."""
        data, targets = self._stage(idx.device)
        return self.ds.build(data[idx].float() / 255.0, targets[idx],
                             x_draw, label_draw, aux_draw)


def get_datamodule(name: str, **kwargs):
    """Dataset registry: the banana source, the image sets and the
    externally ingested ones (`data/external.py`)."""
    if name == "banana":
        from .banana import BananaDataset
        return BananaDataset(**kwargs)
    if name == "stl10_unlabeled":
        # the featurizer trains on the unlabeled images (targets -1), the
        # evaluation splits stay labeled
        return ImageDataset(name="stl10", train_split="unlabeled", **kwargs)
    if name in SPECS:
        return ImageDataset(name=name, **kwargs)
    if name == "imagenet":
        from .external import StreamingImageFolder
        return StreamingImageFolder(name=name, **kwargs)
    if name in ("coco_clip", "coco_captions"):
        from .external import CocoClipDataset
        return CocoClipDataset(**kwargs)
    if name == "galaxy_zoo":
        from .external import GalaxyZooDataset
        return GalaxyZooDataset(**kwargs)
    raise ValueError(f"unknown dataset {name}")
