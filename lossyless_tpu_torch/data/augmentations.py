"""Batched equivalence augmentations on the card: the affine family.

Counterpart of the affine half of `lossyless_tpu/data/augmentations.py`:
rotation, x/y translation, scale and shear (and their `--` weak
variants), whose ranges merge into one random affine warp a batch
(`_merged_affine`: the largest range of each kind; a scale range is the
last one named). Each augmentation is split in two, so that a test can
hand the port JAX's draws: `Affine.draw(generator, shape)` draws the
per-sample angle, shifts, scale and shear on the generator's device, and
`Affine.apply(batch, draw)` warps the batch with them.

The warp samples each output pixel at the inverse-affine source
coordinate about the image centre, bilinear, zero outside:
`F.grid_sample(mode="bilinear", padding_mode="zeros",
align_corners=True)` at the coordinates `_affine_warp` hands
`map_coordinates(order=1, mode="constant", cval=0)`. JAX computes this
warp in XLA, outside any Pallas kernel; here it is the library's op.

Images are NHWC float tensors in [0, 1]. Colour jitter, grayscale,
`resize_crop`, erasing, the flips and the D4 group belong to the STL10
half of ROADMAP queue 1 order 4 and raise until then.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

# (degrees, translate (x, y) fractions, scale range, shear degrees) of
# each affine-family augmentation
_AFFINE_PARAMS = {
    "rotation": dict(degrees=45.0),
    "rotation--": dict(degrees=15.0),
    "y_translation": dict(translate=(0.0, 0.25)),
    "y_translation--": dict(translate=(0.0, 0.15)),
    "x_translation": dict(translate=(0.25, 0.0)),
    "x_translation--": dict(translate=(0.15, 0.0)),
    "shear": dict(shear=25.0),
    "shear--": dict(shear=15.0),
    "scale": dict(scale=(0.6, 1.4)),
    "scale--": dict(scale=(0.8, 1.2)),
}
# the STL10 half of order 4
_NOT_PORTED = ("hflip", "vflip", "D4_group", "color", "gray", "resize_crop",
               "erasing")


@dataclasses.dataclass(frozen=True)
class Affine:
    """A random affine warp: rotation in [-degrees, degrees], shifts of
    [-translate, translate] of the width (x) and height (y), a scale in
    `scale`, a shear in [-shear, shear] degrees."""

    degrees: float = 0.0
    translate: tuple = (0.0, 0.0)
    scale: tuple = (1.0, 1.0)
    shear: float = 0.0

    def draw(self, generator: torch.Generator, shape) -> dict:
        """Per-sample parameters for a batch of NHWC `shape`, as
        `_rand_affine` draws them: the angle and the shear in radians, the
        shifts in pixels, the scale."""
        b, h, w, _ = shape

        def uniform(lo, hi):
            u = torch.rand(b, generator=generator, device=generator.device)
            return u * (hi - lo) + lo

        deg = math.pi / 180.0
        tx, ty = self.translate
        return {"angle": uniform(-self.degrees, self.degrees) * deg,
                "tx": uniform(-tx, tx) * w,
                "ty": uniform(-ty, ty) * h,
                "scale": uniform(*self.scale),
                "shear": uniform(-self.shear, self.shear) * deg}

    @staticmethod
    def apply(batch: torch.Tensor, draw: dict) -> torch.Tensor:
        """Warp each image of the NHWC batch by its drawn parameters."""
        b, h, w, c = batch.shape
        ang, sc, sh = draw["angle"], draw["scale"], draw["shear"]
        cos, sin, tan = torch.cos(ang), torch.sin(ang), torch.tan(sh)
        # inverse transform (output -> input coordinates), (y, x) order
        m00, m01 = cos / sc, (sin + cos * tan) / sc
        m10, m11 = -sin / sc, (cos - sin * tan) / sc
        dev = batch.device
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        ys = (torch.arange(h, dtype=torch.float32, device=dev) - cy)[:, None]
        xs = (torch.arange(w, dtype=torch.float32, device=dev) - cx)[None]

        def per(v):
            return v[:, None, None]

        src_y = per(m00) * ys + per(m01) * xs - per(draw["ty"]) + cy
        src_x = per(m10) * ys + per(m11) * xs - per(draw["tx"]) + cx
        # align_corners=True: -1 and 1 are the centres of the edge pixels
        grid = torch.stack([src_x * (2.0 / max(w - 1, 1)) - 1.0,
                            src_y * (2.0 / max(h - 1, 1)) - 1.0], -1)
        out = F.grid_sample(batch.permute(0, 3, 1, 2).float(), grid,
                            mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        return out.permute(0, 2, 3, 1)

    def __call__(self, generator: torch.Generator, batch: torch.Tensor):
        return self.apply(batch, self.draw(generator, batch.shape))


def _merged_affine(names: Sequence[str]) -> Affine:
    """The affine-family members as one warp: the largest range of each
    kind; a scale range is the last one named."""
    degrees = shear = tx = ty = 0.0
    scale = (1.0, 1.0)
    for n in names:
        p = _AFFINE_PARAMS[n]
        degrees = max(degrees, p.get("degrees", 0.0))
        shear = max(shear, p.get("shear", 0.0))
        t = p.get("translate", (0.0, 0.0))
        tx, ty = max(tx, t[0]), max(ty, t[1])
        scale = p.get("scale", scale)
    return Affine(degrees, (tx, ty), scale, shear)


def make_augmenter(equivalence: Sequence[str]):
    """`augment(generator, batch)` for the named augmentations: every
    affine-family member fused into one warp (`draw` / `apply` reach its
    two halves). An augmentation outside the affine family raises, naming
    its ROADMAP item."""
    unknown = [n for n in equivalence if n not in _AFFINE_PARAMS]
    if any(n in _NOT_PORTED for n in unknown):
        raise NotImplementedError(
            f"the augmentations {unknown} are not ported yet (ROADMAP "
            f"queue 1 order 4, its STL10 half)")
    if unknown:
        raise KeyError(f"unknown augmentations {unknown}")
    return _merged_affine(list(equivalence))


def available_augmentations() -> list[str]:
    """Every name JAX's augmenter takes (the non-affine ones raise)."""
    return sorted(set(_NOT_PORTED) | set(_AFFINE_PARAMS))


def build_augmenter(equivalence):
    """The batch augmenter of an equivalence tuple; falsy -> None."""
    if not equivalence:
        return None
    return make_augmenter(tuple(equivalence))
