"""Weights and inputs made from the run's seed, on the device, in a few
large calls, in the type they are served in."""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = (1 << 63) - 1


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed & MASK)


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A numpy generator of the seed, one independent stream a use."""
    return np.random.default_rng([seed & MASK, stream])


def normal_leaves(shapes: dict, stds: dict, g: torch.Generator, device,
                  dtype=torch.float32, means: dict | None = None) -> dict:
    """name -> N(mean, std) tensor of shapes[name], all drawn by one call."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        leaf = flat[at:at + n].view(shape) * stds[name]
        if means and name in means:
            leaf = leaf + means[name]
        out[name] = leaf.to(dtype)
        at += n
    return out


def tower_weights(shapes: dict, g: torch.Generator, device, dtype) -> dict:
    """A CLIP image tower's weights: dense and patchify kernels N(0,
    1/fan_in), the class token, positions and head N(0, 1/width) (CLIP's
    own init), LayerNorm scales 1 + N(0, 0.05^2), biases N(0, 0.02^2)."""
    width = shapes["class_embedding"][0]
    stds, means = {}, {}
    for name, shape in shapes.items():
        if name.endswith("kernel"):
            stds[name] = math.prod(shape[:-1]) ** -0.5
        elif name.endswith(".scale"):
            stds[name], means[name] = 0.05, 1.0
        elif name.endswith(".bias"):
            stds[name] = 0.02
        else:
            stds[name] = width ** -0.5
    return normal_leaves(shapes, stds, g, device, dtype, means)


def factorized_prior(channels: int, filters, init_scale: float,
                     g: torch.Generator, device) -> dict:
    """Parameters of a factorized prior in CompressAI's layout (`matrix{i}`
    (C, out, in), `bias{i}`, `factor{i}`, `quantiles` (C, 1, 3)) as float32
    numpy: CompressAI's initial matrices, biases U(-0.5, 0.5), factors
    N(0, 0.1^2), quantiles +-init_scale about a median N(0, 0.3^2)."""
    widths = (1, *filters, 1)
    n_layers = len(widths) - 1
    scale = init_scale ** (1.0 / n_layers)

    def draw(fn, shape, s=1.0, shift=0.0):
        t = fn(shape, generator=g, device=device) * s + shift
        return t.cpu().numpy().astype(np.float32)

    out = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        out[f"matrix{i}"] = np.full((channels, b, a),
                                    math.log(math.expm1(1.0 / scale / b)),
                                    np.float32)
        out[f"bias{i}"] = draw(torch.rand, (channels, b, 1), shift=-0.5)
        if i < n_layers - 1:
            out[f"factor{i}"] = draw(torch.randn, (channels, b, 1), 0.1)
    med = draw(torch.randn, (channels,), 0.3)
    out["quantiles"] = np.stack([med - init_scale, med, med + init_scale],
                                -1)[:, None, :].astype(np.float32)
    return out


def affine(channels: int, g: torch.Generator, device, log_scale: float,
           spread: float = 0.1) -> tuple[np.ndarray, np.ndarray]:
    """(scaling, biasing) of the hub's per-dim affine, float32 numpy:
    scaling N(log_scale, spread^2), biasing N(0, spread^2)."""
    z = torch.randn(2, channels, generator=g, device=device).cpu().numpy()
    return ((log_scale + spread * z[0]).astype(np.float32),
            (spread * z[1]).astype(np.float32))


def images(n: int, h: int, w: int, g: torch.Generator, device,
           chunk: int = 1024) -> np.ndarray:
    """(n, h, w, 3) uint8 images, uniform, made on the device in chunks and
    held in host memory as a user's dataset is."""
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        out[i:i + m] = torch.randint(0, 256, (m, h, w, 3), generator=g,
                                     device=device, dtype=torch.uint8
                                     ).cpu().numpy()
    return out
