"""Batched equivalence augmentations on the card.

Counterpart of `lossyless_tpu/data/augmentations.py`: the affine family
(rotation, x/y translation, scale and shear, and their `--` weak
variants), whose ranges merge into one random affine warp a batch
(`_merged_affine`: the largest range of each kind; a scale range is the
last one named), and the others: `hflip`, `vflip`, `D4_group`, `color`
(JAX's own cheap jitter, not torchvision's), `gray`, `resize_crop` and
`erasing`. Each augmentation is split in two, so that a test can hand
the port JAX's draws: `draw(generator, shape)` draws the per-sample
parameters on the generator's device, and `apply(batch, draw)` applies
them. `make_augmenter` chains them as JAX does: the merged affine first,
then the others in the order the equivalence names them; the chain's
draw is the list of its members' draws.

The affine warp samples each output pixel at the inverse-affine source
coordinate about the image centre, bilinear, zero outside:
`F.grid_sample(mode="bilinear", padding_mode="zeros",
align_corners=True)` at the coordinates `_affine_warp` hands
`map_coordinates(order=1, mode="constant", cval=0)`. `resize_crop` is
JAX's `scale_and_translate(method="linear")` at a zoom of at least 1 (no
antialiasing): output pixel i samples (i + 0.5) / zoom + y0 - 0.5, taps
outside the image dropped and the weights renormalized, which is
`F.grid_sample(mode="bilinear", padding_mode="border",
align_corners=False)`. JAX computes all of these in XLA, outside any
Pallas kernel; here they are the library's ops.

Images are NHWC float tensors in [0, 1].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..core import mesh

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


def _uniform(generator: torch.Generator, b: int, lo=0.0, hi=1.0):
    """(b,) fp32 draws from U(lo, hi) on the generator's device (in a
    data-parallel epoch, this rank's rows of the global batch's draw)."""
    u = mesh.global_draw(lambda s: torch.rand(
        s, generator=generator, device=generator.device), (b,))
    return u * (hi - lo) + lo


def _bernoulli(generator: torch.Generator, b: int, p: float):
    """(b,) booleans, each true with probability p (`uniform < p`, as
    `jax.random.bernoulli`)."""
    return _uniform(generator, b) < p


def _per_sample(v: torch.Tensor) -> torch.Tensor:
    """A (B,) draw shaped to broadcast over an NHWC batch."""
    return v.reshape(-1, 1, 1, 1)


class _Augmentation:
    """`draw(generator, shape)` then `apply(batch, draw)`, in one call."""

    def __call__(self, generator: torch.Generator, batch: torch.Tensor):
        return self.apply(batch, self.draw(generator, batch.shape))


@dataclasses.dataclass(frozen=True)
class Affine(_Augmentation):
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
        deg = math.pi / 180.0
        tx, ty = self.translate
        return {"angle": _uniform(generator, b, -self.degrees,
                                  self.degrees) * deg,
                "tx": _uniform(generator, b, -tx, tx) * w,
                "ty": _uniform(generator, b, -ty, ty) * h,
                "scale": _uniform(generator, b, *self.scale),
                "shear": _uniform(generator, b, -self.shear,
                                  self.shear) * deg}

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


@dataclasses.dataclass(frozen=True)
class Flip(_Augmentation):
    """`random_hflip` (dim 2, the width) or `random_vflip` (dim 1): each
    image flipped with probability p."""

    dim: int = 2
    p: float = 0.5

    def draw(self, generator: torch.Generator, shape) -> dict:
        return {"flip": _bernoulli(generator, shape[0], self.p)}

    def apply(self, batch: torch.Tensor, draw: dict) -> torch.Tensor:
        return torch.where(_per_sample(draw["flip"]),
                           batch.flip(self.dim), batch)


@dataclasses.dataclass(frozen=True)
class D4Group(_Augmentation):
    """`d4_group`: an hflip, then a vflip, then a quarter turn
    (`rot90(k=1)` over (H, W)), each with probability 1/2. Square images
    only (galaxy, pcam), as in JAX."""

    def draw(self, generator: torch.Generator, shape) -> dict:
        b = shape[0]
        return {"hflip": _bernoulli(generator, b, 0.5),
                "vflip": _bernoulli(generator, b, 0.5),
                "rot": _bernoulli(generator, b, 0.5)}

    def apply(self, batch: torch.Tensor, draw: dict) -> torch.Tensor:
        batch = Flip(2).apply(batch, {"flip": draw["hflip"]})
        batch = Flip(1).apply(batch, {"flip": draw["vflip"]})
        return torch.where(_per_sample(draw["rot"]),
                           torch.rot90(batch, 1, dims=(1, 2)), batch)


@dataclasses.dataclass(frozen=True)
class ColorJitter(_Augmentation):
    """`color_jitter`, applied to each image with probability p: a
    brightness multiply, contrast about the image's mean over (H, W, C),
    saturation about each pixel's channel mean, the cheap "hue" shift
    `out + hu * (roll(out, 1, channels) - out)`, one clip to [0, 1] at the
    end."""

    brightness: float = 0.4
    contrast: float = 0.4
    saturation: float = 0.4
    hue: float = 0.2
    p: float = 0.8

    def draw(self, generator: torch.Generator, shape) -> dict:
        b = shape[0]
        apply = _bernoulli(generator, b, self.p)
        return {"apply": apply,
                "brightness": 1 + _uniform(generator, b, -self.brightness,
                                           self.brightness),
                "contrast": 1 + _uniform(generator, b, -self.contrast,
                                         self.contrast),
                "saturation": 1 + _uniform(generator, b, -self.saturation,
                                           self.saturation),
                "hue": _uniform(generator, b, -self.hue, self.hue)}

    @staticmethod
    def apply(batch: torch.Tensor, draw: dict) -> torch.Tensor:
        out = batch * _per_sample(draw["brightness"])
        mean = out.mean(dim=(1, 2, 3), keepdim=True)
        out = (out - mean) * _per_sample(draw["contrast"]) + mean
        gray = out.mean(dim=-1, keepdim=True)
        out = (out - gray) * _per_sample(draw["saturation"]) + gray
        out = out + _per_sample(draw["hue"]) * (
            torch.roll(out, 1, dims=-1) - out)
        out = out.clamp(0.0, 1.0)
        return torch.where(_per_sample(draw["apply"]), out, batch)


@dataclasses.dataclass(frozen=True)
class Grayscale(_Augmentation):
    """`random_grayscale`: with probability p, the 0.299 / 0.587 / 0.114
    luminance in all three channels."""

    p: float = 0.2

    def draw(self, generator: torch.Generator, shape) -> dict:
        return {"apply": _bernoulli(generator, shape[0], self.p)}

    @staticmethod
    def apply(batch: torch.Tensor, draw: dict) -> torch.Tensor:
        lum = (0.299 * batch[..., 0] + 0.587 * batch[..., 1]
               + 0.114 * batch[..., 2])[..., None]
        return torch.where(_per_sample(draw["apply"]),
                           lum.expand(batch.shape), batch)


@dataclasses.dataclass(frozen=True)
class ResizedCrop(_Augmentation):
    """`random_resized_crop`: a crop of area fraction in `scale` and
    aspect ratio in `ratio` (log-uniform), its corner uniform over the
    valid range, resized back to the image's size.

    The draw keeps JAX's four uniforms (`area`, `log_r`, `u_y`, `u_x`);
    `apply` derives the crop from them in fp32, as JAX does:
    ch = sqrt(area / r) and cw = sqrt(area * r) clipped at 1, y0 =
    u_y (1 - ch) h."""

    scale: tuple = (0.3, 1.0)
    ratio: tuple = (0.7, 1.4)

    def draw(self, generator: torch.Generator, shape) -> dict:
        b = shape[0]
        return {"area": _uniform(generator, b, *self.scale),
                "log_r": _uniform(generator, b, math.log(self.ratio[0]),
                                  math.log(self.ratio[1])),
                "u_y": _uniform(generator, b),
                "u_x": _uniform(generator, b)}

    @staticmethod
    def apply(batch: torch.Tensor, draw: dict) -> torch.Tensor:
        b, h, w, _ = batch.shape
        area, r = draw["area"], torch.exp(draw["log_r"])
        ch = torch.sqrt(area / r).clamp(max=1.0)
        cw = torch.sqrt(area * r).clamp(max=1.0)
        y0 = draw["u_y"] * (1 - ch) * h
        x0 = draw["u_x"] * (1 - cw) * w

        def coords(n, frac, start):
            # scale_and_translate's sample position of output pixel i,
            # at zoom 1 / frac: (i + 0.5) * frac + start - 0.5, then as
            # a grid_sample coordinate (align_corners=False)
            i = torch.arange(n, dtype=torch.float32, device=batch.device)
            pos = (i[None] + 0.5) * frac[:, None] + start[:, None] - 0.5
            return (2.0 * pos + 1.0) / n - 1.0

        gy, gx = coords(h, ch, y0), coords(w, cw, x0)
        grid = torch.stack(torch.broadcast_tensors(
            gx[:, None, :], gy[:, :, None]), -1)
        out = F.grid_sample(batch.permute(0, 3, 1, 2).float(), grid,
                            mode="bilinear", padding_mode="border",
                            align_corners=False)
        return out.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class Erasing(_Augmentation):
    """`random_erasing`: with probability p, a rectangle of area fraction
    in `scale` (square in fractions of H and W) filled with `value`. Its
    sides and corner truncate toward zero, as JAX's int32 casts."""

    value: float = 0.5
    scale: tuple = (0.02, 0.33)
    p: float = 0.5

    def draw(self, generator: torch.Generator, shape) -> dict:
        b = shape[0]
        return {"apply": _bernoulli(generator, b, self.p),
                "area": _uniform(generator, b, *self.scale),
                "u_y": _uniform(generator, b),
                "u_x": _uniform(generator, b)}

    def apply(self, batch: torch.Tensor, draw: dict) -> torch.Tensor:
        b, h, w, _ = batch.shape
        side = torch.sqrt(draw["area"])
        eh = (side * h).to(torch.int32).clamp(1, h)
        ew = (side * w).to(torch.int32).clamp(1, w)
        y0 = (draw["u_y"] * (h - eh)).to(torch.int32)
        x0 = (draw["u_x"] * (w - ew)).to(torch.int32)
        yy = torch.arange(h, device=batch.device)[None, :, None]
        xx = torch.arange(w, device=batch.device)[None, None, :]

        def per(v):
            return v[:, None, None]

        mask = ((yy >= per(y0)) & (yy < per(y0 + eh))
                & (xx >= per(x0)) & (xx < per(x0 + ew)))[..., None]
        erased = torch.where(mask, torch.full_like(batch, self.value),
                             batch)
        return torch.where(_per_sample(draw["apply"]), erased, batch)


_REGISTRY = {
    "hflip": Flip(2),
    "vflip": Flip(1),
    "D4_group": D4Group(),
    "color": ColorJitter(),
    "gray": Grayscale(),
    "resize_crop": ResizedCrop(),
    "erasing": Erasing(),
}


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


@dataclasses.dataclass(frozen=True)
class Chain(_Augmentation):
    """Augmentations applied in order; the draw is the list of the
    members' draws, in the same order."""

    members: tuple

    def draw(self, generator: torch.Generator, shape) -> list:
        return [m.draw(generator, shape) for m in self.members]

    def apply(self, batch: torch.Tensor, draws: Sequence[dict]):
        if len(draws) != len(self.members):
            raise ValueError(f"{len(draws)} draws for {len(self.members)} "
                             f"augmentations")
        for m, d in zip(self.members, draws):
            batch = m.apply(batch, d)
        return batch


def make_augmenter(equivalence: Sequence[str]) -> Chain:
    """The chain of the named augmentations: every affine-family member
    fused into one warp, first, then the others in the order named."""
    unknown = [n for n in equivalence
               if n not in _AFFINE_PARAMS and n not in _REGISTRY]
    if unknown:
        raise KeyError(f"unknown augmentations {unknown}")
    affine = [n for n in equivalence if n in _AFFINE_PARAMS]
    members = [_merged_affine(affine)] if affine else []
    members += [_REGISTRY[n] for n in equivalence if n in _REGISTRY]
    return Chain(tuple(members))


def available_augmentations() -> list[str]:
    """Every name the augmenter takes (JAX's list)."""
    return sorted(set(_REGISTRY) | set(_AFFINE_PARAMS))


def build_augmenter(equivalence):
    """The batch augmenter of an equivalence tuple; falsy -> None."""
    if not equivalence:
        return None
    return make_augmenter(tuple(equivalence))
