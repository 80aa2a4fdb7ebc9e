"""Faults planted under the timed path, to show that the check catches
them (the tests) and to read the numbers they give (`calibrate.py
--fault`). Each is a context manager that patches the program's classes
for as long as it is open; none is ever planted in a benchmark run.

* `unchanged`: every optimizer step returns the state as it was;
* `half_batch`: training: the distortion of half the rows (its mean over
  them, each counted twice); encode: half of each batch reaches the card;
* `altered`: training: one gradient doubled where the optimizer gets it;
  encode: the first image's symbols of every batch moved by one;
* `k3_backward`: training: K3's backward (`coding.eb_kernel`) returns
  zeros, so the rate trains nothing.

One card runs every cell, so no cell has an exchange between chips to
leave out.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(cls, name, make):
    own = cls.__dict__.get(name)     # None where the class inherits it
    setattr(cls, name, make(getattr(cls, name)))
    try:
        yield
    finally:
        if own is None:
            delattr(cls, name)
        else:
            setattr(cls, name, own)


def _unchanged(orig):
    def step(self, closure=None):
        return None
    return step


def _altered_grad(orig):
    def step(self, closure=None):
        p = self.param_groups[0]["params"][0]
        if p.grad is not None:
            p.grad.mul_(2.0)
        return orig(self, closure)
    return step


def _zero_backward(orig):
    def backward(ctx, g):
        return tuple(None if t is None else torch.zeros_like(t)
                     for t in orig(ctx, g))
    return staticmethod(backward)


def _half_distortion(orig):
    def forward(self, z_hat, z_pos_hat, p_zlx=None, *, training=False):
        half = z_hat.shape[0] // 2
        dist, logs = orig(self, z_hat[:half], z_pos_hat[:half], p_zlx,
                          training=training)
        return dist.repeat(2), logs
    return forward


def _half_batch(orig):
    def to_device(self, x):
        return orig(self, x[:max(1, len(x) // 2)])
    return to_device


def _altered_symbols(orig):
    def encode(self, x):
        out = orig(self, x)
        out[0] += 1
        return out
    return encode


@contextlib.contextmanager
def plant(name: str, kind: str):
    """Plant fault `name` for a cell whose driver is `kind` ("train" or
    "encode")."""
    if kind == "train":
        from lossyless_tpu_torch.coding.eb_kernel import _EBLikelihood
        from lossyless_tpu_torch.compressors.distortions import \
            ContrastiveDistortion
        patches = {
            "k3_backward": (_EBLikelihood, "backward", _zero_backward),
            "unchanged": (torch.optim.AdamW, "step", _unchanged),
            "half_batch": (ContrastiveDistortion, "forward",
                           _half_distortion),
            "altered": (torch.optim.AdamW, "step", _altered_grad)}
    else:
        from lossyless_tpu_torch.hub.compressor import ClipCompressor
        patches = {
            "half_batch": (ClipCompressor, "_to_device", _half_batch),
            "altered": (ClipCompressor, "_encode_symbols", _altered_symbols)}
    if name not in patches:
        raise KeyError(f"no fault {name!r} for {kind} cells")
    with _patched(*patches[name]):
        yield
