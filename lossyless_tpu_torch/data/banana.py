"""Banana 2-D toy source with exact group actions and max-invariants.

Counterpart of `lossyless_tpu/data/banana.py`: a Gaussian pushed through a
curvature transform, rotated and shifted, with rotation / x- / y-translation
equivalences.

* `BananaDistribution`, `rotate` and `BananaDataset` are the JAX package's
  host numpy code, copied as is: the same seed gives the same data,
  quantiles and batches, byte for byte. `batches` yields CPU tensors made
  from those arrays.
* `device_sample_batch` / `BananaDataset.device_sampler` draw a batch on
  the device from an explicit `torch.Generator`: the same distribution,
  invariants and representatives as the host path (the draws are torch's,
  not `jax.random`'s). The constants enter as Python scalars, so a batch
  needs no host->device copy.

`additional_target`: "representative" (VIC: the aux target is the orbit's
canonical representative and the input is resampled uniformly on that
orbit), "input" (VAE: the aux target is x), "equiv_x" (a second sample of
the same orbit: the contrastive positive), "target" (the max-invariant).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import mesh

# uniform translation ranges of the device sampler (the 10% and 90%
# quantiles of the source along x and y, precomputed from 1e6 samples)
TRANSLATION_RANGE = {0: (-3.30, 2.59), 1: (-3.03, 1.93)}


def rotate(x: np.ndarray, angle_deg) -> np.ndarray:
    """Rotate 2D points by `angle_deg` degrees."""
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, -s], [s, c]], dtype=x.dtype)
    return x @ rot.T


@dataclasses.dataclass
class BananaDistribution:
    curvature: float = 0.05
    factor: float = 6.0
    location: tuple = (-1.5, -2.0)
    angle: float = -40.0
    scale: float = 0.5

    def sample(self, n: int, rng: np.random.Generator) -> np.ndarray:
        std = np.array([self.factor * self.scale, self.scale], np.float32)
        x = rng.normal(0.0, 1.0, (n, 2)).astype(np.float32) * std
        # banana shift
        curv = self.curvature / self.scale
        fac = self.factor * self.scale
        shift = np.zeros_like(x)
        shift[:, 1] = curv * (x[:, 0] ** 2 - fac ** 2)
        x = x + shift
        x = rotate(x, self.angle)
        return x + np.asarray(self.location, np.float32) * self.scale


def _rotation(angle_deg: float) -> tuple[float, float]:
    """(cos, sin) of the angle, in fp32 as `jnp.deg2rad` gives them."""
    a = np.deg2rad(np.float32(angle_deg))
    return float(np.cos(a)), float(np.sin(a))


def _rotate_by(x: torch.Tensor, c, s) -> torch.Tensor:
    """Rotate rows of x (B, 2) by the angle of (cos, sin) c, s (scalars or
    (B,) tensors)."""
    return torch.stack([c * x[:, 0] - s * x[:, 1],
                        s * x[:, 0] + c * x[:, 1]], -1)


def device_sample_batch(generator: torch.Generator, batch_size: int,
                        equivalence: str | None = "rotation",
                        additional_target: str = "representative"):
    """One (x, Mx, aux) banana batch drawn on `generator`'s device.

    Draws, in order: the base normals, then one uniform a sample for the
    resampled input ("representative") or the positive ("equiv_x"). The
    constants enter as Python scalars: nothing is copied to the device. In
    a data-parallel epoch `batch_size` is a rank's rows: each draw is the
    global batch's, this rank's rows kept (`core.mesh.global_draw`).
    """
    device = generator.device
    d = BananaDistribution()
    n = mesh.global_draw(lambda s: torch.randn(
        s, generator=generator, device=device), (batch_size, 2))
    curv, fac = d.curvature / d.scale, d.factor * d.scale
    x0 = n[:, 0] * fac
    x1 = n[:, 1] * d.scale + curv * (x0 ** 2 - fac ** 2)
    c, s = _rotation(d.angle)
    x = torch.stack([c * x0 - s * x1 + d.location[0] * d.scale,
                     s * x0 + c * x1 + d.location[1] * d.scale], -1)

    def uniform(lo: float, hi: float):
        u = mesh.global_draw(lambda s: torch.rand(
            s, generator=generator, device=device), (batch_size,))
        return u * (hi - lo) + lo

    if equivalence == "rotation":
        mx = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        rep = _rotate_by(torch.cat([-mx, torch.zeros_like(mx)], -1),
                         *_rotation(45.0))
        if additional_target == "representative":
            ang = uniform(0.0, 2 * math.pi)
            x = _rotate_by(rep, torch.cos(ang), torch.sin(ang))
            aux = rep
        elif additional_target == "input":
            aux = x
        elif additional_target == "equiv_x":
            ang = uniform(0.0, 2 * math.pi)
            aux = _rotate_by(x, torch.cos(ang), torch.sin(ang))
        else:
            aux = mx
    elif equivalence in ("x_translation", "y_translation"):
        axis = 0 if equivalence == "y_translation" else 1
        jitter_axis = 1 - axis
        mx = x[:, axis:axis + 1]
        zero = torch.zeros_like(mx)
        rep = torch.cat([mx, zero] if axis == 0 else [zero, mx], -1)
        lo, hi = TRANSLATION_RANGE[jitter_axis]
        if additional_target == "representative":
            jit = uniform(lo, hi)[:, None]
            x = rep + torch.cat([zero, jit] if axis == 0 else [jit, zero],
                                -1)
            aux = rep
        elif additional_target == "input":
            aux = x
        elif additional_target == "equiv_x":
            # same orbit = same invariant coordinate, a fresh translation
            jit = uniform(lo, hi)[:, None]
            aux = torch.cat([mx, jit] if axis == 0 else [jit, mx], -1)
        else:
            aux = mx
    else:
        mx = x
        aux = x if additional_target in ("representative", "input") else mx
    return x, mx, aux


@dataclasses.dataclass
class BananaDataset:
    """In-memory banana dataset with equivalence machinery."""

    length: int = 102400
    equivalence: str | None = "rotation"  # rotation|x_translation|y_translation|None
    additional_target: str = "representative"  # representative|input|equiv_x|target
    seed: int | None = 123

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.distribution = BananaDistribution()
        self.data = self.distribution.sample(self.length, rng)
        self.targets = self.max_invariant(self.data)
        # quantiles for the translation action ranges
        self.min_x, self.min_y = np.quantile(self.data, 0.1, axis=0)
        self.max_x, self.max_y = np.quantile(self.data, 0.9, axis=0)
        self._rng = rng

    def __len__(self):
        return self.length

    def max_invariant(self, samples: np.ndarray) -> np.ndarray:
        if self.equivalence == "rotation":
            return np.linalg.norm(samples, axis=-1, keepdims=True)
        if self.equivalence == "y_translation":
            return samples[:, :1]
        if self.equivalence == "x_translation":
            return samples[:, 1:]
        if self.equivalence is None:
            return samples
        raise ValueError(f"unknown equivalence={self.equivalence}")

    def representative(self, mx: np.ndarray) -> np.ndarray:
        if self.equivalence == "rotation":
            left = np.concatenate([-mx, np.zeros_like(mx)], axis=-1)
            return rotate(left, 45.0)
        if self.equivalence == "y_translation":
            return np.concatenate([mx, np.zeros_like(mx)], axis=-1)
        if self.equivalence == "x_translation":
            return np.concatenate([np.zeros_like(mx), mx], axis=-1)
        if self.equivalence is None:
            return mx
        raise ValueError(f"unknown equivalence={self.equivalence}")

    def sample_action(self, rep: np.ndarray, rng) -> np.ndarray:
        if self.equivalence == "rotation":
            angles = rng.uniform(0, 360, size=(rep.shape[0],))
            a = np.deg2rad(angles).astype(np.float32)
            c, s = np.cos(a), np.sin(a)
            x, y = rep[:, 0], rep[:, 1]
            return np.stack([c * x - s * y, s * x + c * y], axis=-1)
        if self.equivalence == "y_translation":
            jit = rng.uniform(self.min_y, self.max_y, (rep.shape[0],))
            out = rep.copy()
            out[:, 1] += jit.astype(np.float32)
            return out
        if self.equivalence == "x_translation":
            jit = rng.uniform(self.min_x, self.max_x, (rep.shape[0],))
            out = rep.copy()
            out[:, 0] += jit.astype(np.float32)
            return out
        return rep

    def device_sampler(self, batch_size: int):
        """`sample(generator) -> (x, Mx, aux)`: fresh batches drawn on the
        generator's device (the banana source is generative)."""
        eq, at = self.equivalence, self.additional_target

        def sample(generator: torch.Generator):
            return device_sample_batch(generator, batch_size, equivalence=eq,
                                       additional_target=at)

        return sample

    def batches(self, batch_size: int, n_epochs: int = 1, seed: int = 0):
        """Yield (x, y, aux_target) CPU tensors; a ragged tail is dropped."""
        rng = np.random.default_rng(seed)
        for _ in range(n_epochs):
            perm = rng.permutation(self.length)
            for i in range(0, self.length - batch_size + 1, batch_size):
                idx = perm[i:i + batch_size]
                x = self.data[idx]
                mx = self.targets[idx]
                if self.additional_target == "representative":
                    rep = self.representative(mx)
                    # resampling on the orbit
                    x = self.sample_action(rep, rng)
                    aux = rep
                elif self.additional_target == "input":
                    aux = x
                elif self.additional_target == "equiv_x":
                    # a second, independent sample from the same orbit
                    aux = self.sample_action(self.representative(mx), rng)
                elif self.additional_target == "target":
                    aux = mx
                else:
                    raise ValueError(self.additional_target)
                yield tuple(torch.from_numpy(np.ascontiguousarray(a))
                            for a in (x, mx, aux))
