"""Equivariant augmentations: joint (image, label) transforms.

Counterpart of `lossyless_tpu/data/label_augment.py`: the crop scale axis
is split into [left-equivariant | invariant | right-equivariant] ranges,
each chosen with probability proportional to its width. A sample whose
crop lands in an equivariant range gets its label resampled uniformly
with probability `p`; an invariant-range crop keeps its label.

As the augmentations, it is a draw and an apply, so a test can hand the
port JAX's draws: `draw(generator, shape)` draws the range of each
sample (the inverse CDF of a uniform over `range_probs`), one crop draw
under each of the three ranges, the resampling coin and the new label;
`apply(batch, labels, draw)` crops each sample under its range's draw
and resamples the labels. JAX crops every sample under all three ranges
and selects one; the crop of a sample depends only on its own draw, so
cropping once under the selected draw gives the same images.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import mesh
from .augmentations import ResizedCrop, _bernoulli, _uniform


@dataclasses.dataclass(frozen=True)
class EquivariantRandomResizedCrop:
    invariant_scale: tuple = (0.5, 1.0)
    equivariant_scale: tuple = (0.3, 1.0)
    ratio: tuple = (0.7, 1.4)
    p: float = 1.0
    num_classes: int = 10

    def __post_init__(self):
        eq, inv = self.equivariant_scale, self.invariant_scale
        if not (eq[0] <= inv[0] and inv[1] <= eq[1]):
            raise ValueError("equivariant scale range must contain the "
                             "invariant range")

    @property
    def range_probs(self) -> list[float]:
        """The left, invariant and right ranges' probabilities."""
        eq, inv = self.equivariant_scale, self.invariant_scale
        widths = [inv[0] - eq[0], inv[1] - inv[0], eq[1] - inv[1]]
        return [w / sum(widths) for w in widths]

    @property
    def crops(self) -> tuple:
        """The crop of each range: left, invariant, right."""
        eq, inv = self.equivariant_scale, self.invariant_scale
        return tuple(ResizedCrop(scale, self.ratio) for scale in (
            (eq[0], inv[0]), (inv[0], inv[1]), (inv[1], eq[1])))

    def draw(self, generator: torch.Generator, shape) -> dict:
        b = shape[0]
        p0, p1, _ = self.range_probs
        u = _uniform(generator, b)
        which = (u >= p0).long() + (u >= p0 + p1).long()
        return {"which": which,
                "crops": [c.draw(generator, shape) for c in self.crops],
                "flip": _bernoulli(generator, b, self.p),
                "new_y": mesh.global_draw(lambda s: torch.randint(
                    0, self.num_classes, s, generator=generator,
                    device=generator.device), (b,))}

    def apply(self, batch: torch.Tensor, labels: torch.Tensor,
              draw: dict):
        """(the cropped batch, the labels, resampled where drawn)."""
        which = draw["which"].to(batch.device)
        crop = {k: torch.stack([d[k] for d in draw["crops"]], 1).gather(
            1, which[:, None])[:, 0] for k in draw["crops"][0]}
        out = ResizedCrop.apply(batch, crop)
        resample = draw["flip"].to(labels.device) & (which != 1).to(
            labels.device)
        labels = torch.where(resample, draw["new_y"].to(labels), labels)
        return out, labels

    def __call__(self, generator: torch.Generator, batch, labels):
        return self.apply(batch, labels, self.draw(generator, batch.shape))
