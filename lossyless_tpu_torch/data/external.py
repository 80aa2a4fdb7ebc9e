"""Externally ingested datasets: ImageNet folders, COCO captions, Galaxy Zoo.

Counterpart of `lossyless_tpu/data/external.py`. These read the on-disk
layouts that `data.ingest` writes (or the official distributions) lazily:
paths are indexed at construction, and each batch's JPEGs are decoded by
`data.loader`'s thread pool on a prefetch thread while the card runs the
previous batch.

Contract, as every datamodule's: `len()`, `spec`, `aux_shape` and
`batches(batch_size, n_epochs, seed, shuffle, drop_last)` of `(x, y,
aux)`, x float32 NHWC in [0, 1]. The order is JAX's: one
`np.random.default_rng(seed)` serves every epoch's permutation and, for
COCO, each row's caption pick, so images and caption features come in
JAX's order bit for bit. The batches lie on the dataset's `device` (the
card unless given; resolved when batches are asked for, so building a
dataset needs no card), where the equivalence augmentations run, drawn
from a `torch.Generator` on that device seeded with `seed`: x's chain
first, then an `equiv_x` positive's (`data/augmentations.py`: a test can
hand `apply` JAX's draws).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..core.device import resolve_device
from .augmentations import build_augmenter
from .images import DATA_DIR, ImageSpec

# the names `data.images.get_datamodule` routes here
EXTERNAL_DATASETS = ("imagenet", "coco_clip", "coco_captions", "galaxy_zoo")
IMAGENET_SPEC = ImageSpec("imagenet", (224, 224, 3), 1000,
                          ("hflip", "resize_crop", "color", "gray"))
COCO_SPEC = ImageSpec("coco_captions", (224, 224, 3), 1)
# the reference's galaxy equivalence set (its config/data/galaxy.yaml)
GALAXY_ZOO_SPEC = ImageSpec("galaxy_zoo", (128, 128, 3), 37,
                            ("resize_crop", "D4_group", "color", "gray"))


def _load_jpeg_batch(paths, size) -> np.ndarray:
    """uint8 (B, H, W, 3) of `paths` decoded and resized on the thread
    pool (the same bytes at any worker count)."""
    from .loader import decode_image_batch

    return decode_image_batch(paths, size)


def _epochs(rng: np.random.Generator, n: int, batch_size: int,
            n_epochs: int, shuffle: bool, drop_last: bool):
    """Each batch's indices: a permutation an epoch drawn from `rng` (or
    the identity), full batches and, without `drop_last`, the tail."""
    for _ in range(n_epochs):
        order = rng.permutation(n) if shuffle else np.arange(n)
        stop = n - batch_size + 1 if drop_last else n
        for i in range(0, stop, batch_size):
            yield order[i:i + batch_size]


def _to_unit(images: np.ndarray, device) -> torch.Tensor:
    """[0, 1] float32 images on `device`: uint8 is divided by 255 there
    (fp32 division, the bytes of numpy's), float is moved as it is."""
    t = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    return t.float() / 255.0 if t.dtype == torch.uint8 else t


class _Augmented:
    """The equivalence chain of a dataset with `equivalence`,
    `is_augment` and `device` fields."""

    def augmenter(self):
        """The chain when this dataset augments, else None."""
        return build_augmenter(self.equivalence) if self.is_augment \
            else None

    def _stream(self, seed: int):
        """(the resolved device, a generator on it seeded with `seed`,
        the chain or None)."""
        device = resolve_device(self.device)
        return (device, torch.Generator(device).manual_seed(seed),
                self.augmenter())

    def batches(self, batch_size: int, n_epochs: int = 1, seed: int = 0,
                shuffle: bool = True, drop_last: bool = True):
        """The batch stream, produced on a prefetch thread (the same
        batches as the inline generator: `data.loader.prefetch`)."""
        from .loader import prefetch

        return prefetch(self._iter_batches(batch_size, n_epochs, seed,
                                           shuffle, drop_last))


def _view(augment, generator, raw: torch.Tensor) -> torch.Tensor:
    return raw if augment is None else augment.apply(
        raw, augment.draw(generator, raw.shape))


@dataclasses.dataclass
class StreamingImageFolder(_Augmented):
    """A class-per-subdirectory image folder read lazily, for datasets
    too large to hold in memory.

    ImageNet: `<data_dir>/imagenet256` is preferred over
    `<data_dir>/imagenet`, and the test split reads `val` (the test
    labels were never released)."""

    name: str = "imagenet"
    split: str = "train"
    additional_target: str | None = "representative"
    data_dir: Path = DATA_DIR
    # None -> the spec's set; the pipeline builds its evaluation splits
    # with is_augment=False
    equivalence: tuple | None = None
    is_augment: bool = True
    device: Any = None

    def __post_init__(self):
        self.spec = IMAGENET_SPEC if self.name == "imagenet" \
            else dataclasses.replace(IMAGENET_SPEC, name=self.name)
        if self.equivalence is None:
            self.equivalence = self.spec.default_equivalence
        if self.name == "imagenet":
            root = next((Path(self.data_dir) / c for c in
                         ("imagenet256", "imagenet")
                         if (Path(self.data_dir) / c).exists()), None)
            if root is None:
                raise FileNotFoundError(
                    f"neither imagenet256 nor imagenet found under "
                    f"{self.data_dir}; install it there (no public "
                    f"download)")
            split = "val" if self.split in ("test", "validation") \
                else self.split
        else:
            root, split = Path(self.data_dir) / self.name, self.split
        split_dir = root / split
        if not split_dir.exists():
            raise FileNotFoundError(split_dir)
        self.classes = sorted(d.name for d in split_dir.iterdir()
                              if d.is_dir())
        self.paths, targets = [], []
        for ci, cname in enumerate(self.classes):
            for f in sorted((split_dir / cname).iterdir()):
                if f.suffix.lower() in (".jpeg", ".jpg", ".png"):
                    self.paths.append(f)
                    targets.append(ci)
        self.targets = np.asarray(targets, np.int64)
        self.n_classes = max(len(self.classes), self.spec.n_classes)

    def __len__(self):
        return len(self.paths)

    @property
    def aux_shape(self):
        if self.additional_target == "target":
            return self.spec.n_classes
        return self.spec.shape

    def _iter_batches(self, batch_size, n_epochs, seed, shuffle, drop_last):
        h, w, _ = self.spec.shape
        device, g, augment = self._stream(seed)
        rng = np.random.default_rng(seed)
        at = self.additional_target
        for idx in _epochs(rng, len(self), batch_size, n_epochs, shuffle,
                           drop_last):
            raw = _to_unit(_load_jpeg_batch([self.paths[j] for j in idx],
                                            (h, w)), device)
            x = _view(augment, g, raw)
            y = torch.from_numpy(self.targets[idx]).to(device)
            if at in ("target", None):
                aux = y.float()
            elif at == "input":
                aux = x                      # the augmented view
            elif at == "representative":
                aux = raw                    # the un-augmented image
            elif at == "equiv_x":            # an independent second view
                aux = _view(augment, g, raw)
            else:
                raise ValueError(f"unknown additional_target={at}")
            yield x, y, aux


@dataclasses.dataclass
class CocoClipDataset(_Augmented):
    """Ingested COCO captions: the image x and, as aux, the CLIP text
    features of one of its captions, picked at random for each row (an
    image's equivalence class: the images one caption describes).
    Targets are -1 (no labels)."""

    split: str = "train"
    data_dir: Path = DATA_DIR
    additional_target: str | None = "equiv_x"
    # off by default: ingestion stores the centre 224 px square, so the
    # deterministic view is the recipe's; opt in through
    # data_feat.kwargs.equivalence (e.g. ("resize_crop",))
    equivalence: tuple | None = None
    is_augment: bool = True
    device: Any = None

    def __post_init__(self):
        self.spec = COCO_SPEC
        if self.split == "validation":  # no validation split: train's
            self.split = "train"
        split_dir = Path(self.data_dir) / "coco_captions" / self.split
        if not split_dir.exists():
            raise FileNotFoundError(
                f"{split_dir} missing; run data.ingest.ingest_coco_clip")
        self.split_dir = split_dir
        self.paths = sorted(split_dir.glob("*th_img.jpeg"),
                            key=lambda p: int(p.name.split("th")[0]))
        self._feat_dim = None

    def __len__(self):
        return len(self.paths)

    @staticmethod
    def _features_of(img: Path) -> np.ndarray:
        # the feature file of the image file's own index: a partial
        # ingest's indices need not be contiguous
        return np.load(img.with_name(
            img.name.replace("th_img.jpeg", "th_features.npy")))

    @property
    def feat_dim(self) -> int:
        if self._feat_dim is None:
            self._feat_dim = int(self._features_of(self.paths[0]).shape[-1])
        return self._feat_dim

    @property
    def aux_shape(self):
        return (self.feat_dim,)

    def _iter_batches(self, batch_size, n_epochs, seed, shuffle, drop_last):
        h, w, _ = self.spec.shape
        device, g, augment = self._stream(seed)
        rng = np.random.default_rng(seed)
        for idx in _epochs(rng, len(self), batch_size, n_epochs, shuffle,
                           drop_last):
            x = _view(augment, g, _to_unit(_load_jpeg_batch(
                [self.paths[j] for j in idx], (h, w)), device))
            aux = np.empty((len(idx), self.feat_dim), np.float32)
            for r, j in enumerate(idx):
                feats = self._features_of(self.paths[j])
                aux[r] = feats[rng.integers(len(feats))]
            y = torch.full((len(idx),), -1, dtype=torch.int64,
                           device=device)
            yield x, y, torch.from_numpy(aux).to(device)


@dataclasses.dataclass
class GalaxyZooDataset(_Augmented):
    """Ingested Galaxy Zoo: 37 regression targets (vote fractions) a
    galaxy. The test split has no targets (zeros) and carries the
    GalaxyIDs (`ids`) for the kaggle submission. `synthetic=True` makes
    uniform images and Dirichlet targets from `seed` instead, JAX's
    bytes; without it a missing tree raises."""

    split: str = "train"
    data_dir: Path = DATA_DIR
    additional_target: str | None = "target"
    # None -> the spec's set; the pipeline passes is_augment=False for
    # evaluation
    equivalence: tuple | None = None
    is_augment: bool = True
    synthetic: bool = False
    synthetic_n: int = 2048
    seed: int = 0
    # the training resolution (0: the spec's 128); JPEGs are resized at
    # load, so one ingested tree serves every size
    resolution: int = 0
    device: Any = None

    def __post_init__(self):
        self.spec = GALAXY_ZOO_SPEC
        if self.resolution:
            self.spec = dataclasses.replace(
                self.spec, shape=(self.resolution, self.resolution,
                                  self.spec.shape[2]))
        if self.equivalence is None:
            self.equivalence = self.spec.default_equivalence
        if self.split == "validation":  # no validation split: train's
            self.split = "train"
        root = Path(self.data_dir) / "galaxy"
        split_dir = root / self.split
        if self.synthetic:
            rng = np.random.default_rng(
                self.seed + (0 if self.split == "train" else 1))
            h, w, c = self.spec.shape
            self._synth_x = rng.uniform(
                0, 1, (self.synthetic_n, h, w, c)).astype(np.float32)
            self.targets = rng.dirichlet(
                np.ones(37), self.synthetic_n).astype(np.float32)
            self.paths = [None] * self.synthetic_n
            return
        if not split_dir.exists():
            raise FileNotFoundError(
                f"{split_dir} missing; run data.ingest.ingest_kaggle_galaxy "
                f"or pass synthetic=True")
        self.split_dir = split_dir
        self.paths = sorted(split_dir.glob("*th_img.jpeg"),
                            key=lambda p: int(p.name.split("th")[0]))
        if self.split == "train":
            self.targets = np.load(root / "train_targets.npy")
        else:  # kaggle holds the test targets back
            self.ids = np.load(root / f"{self.split}_ids.npy")
            self.targets = np.zeros((len(self.paths), 37), np.float32)

    def __len__(self):
        return len(self.paths)

    @property
    def aux_shape(self):
        # image-valued aux: "input" / "representative" (reconstruction
        # targets) and "equiv_x" (a second view); else the 37 targets
        if self.additional_target in ("input", "representative", "equiv_x"):
            return self.spec.shape
        return 37

    def _iter_batches(self, batch_size, n_epochs, seed, shuffle, drop_last):
        h, w, _ = self.spec.shape
        device, g, augment = self._stream(seed)
        rng = np.random.default_rng(seed)
        at = self.additional_target
        for idx in _epochs(rng, len(self), batch_size, n_epochs, shuffle,
                           drop_last):
            raw = _to_unit(self._synth_x[idx] if self.synthetic
                           else _load_jpeg_batch([self.paths[j] for j in idx],
                                                 (h, w)), device)
            y = torch.from_numpy(self.targets[idx].astype(np.float32)).to(
                device)
            x = _view(augment, g, raw)
            if at == "input":
                aux = x                      # the reconstruction target
            elif at == "representative":
                aux = raw
            elif at == "equiv_x":            # an independent second view
                aux = _view(augment, g, raw)
            elif at in ("target", None):
                aux = y.clone()
            else:
                raise ValueError(f"unknown additional_target={at}")
            yield x, y, aux
