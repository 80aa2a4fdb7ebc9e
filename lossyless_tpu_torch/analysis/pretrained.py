"""Reload trained experiments for offline analysis and plotting.

Counterpart of `lossyless_tpu/analysis/pretrained.py`
(`PretrainedAnalyser`): rebuild the model from a pipeline config as the
pipeline does (`pipeline/run.py::build_state`), load the exported best
featurizer weights, and expose encode and decode functions for the
visualization suite (codebook plots, traversals, reconstructions) without
running training again. It runs on the card unless `device` names another
device.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch


class PretrainedAnalyser:
    def __init__(self, cfg, ckpt_dir: str | Path | None = None,
                 device=None):
        from ..core.device import resolve_device
        from ..pipeline.config import apply_precision
        from ..pipeline.run import build_state, instantiate_datamodule
        from ..train.checkpoints import load_weights

        self.device = resolve_device(device)
        self.cfg = apply_precision(copy.deepcopy(cfg))
        self.dataset = instantiate_datamodule(self.cfg, self.cfg.data_feat,
                                              device=self.device)
        self.state = build_state(self.cfg, 0, device=self.device)
        ckpt_dir = Path(ckpt_dir or self.cfg.ckpt_dir)
        self.state.model.load_state_dict(load_weights(
            ckpt_dir / self.cfg.long_name / "best_featurizer"))
        self.model = self.state.model.eval()

    def _in(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def featurize(self, x) -> torch.Tensor:
        """x -> the quantized latents z_hat, on the analyser's device."""
        return self.model.features(self._in(x))

    @torch.no_grad()
    def reconstruct(self, x) -> torch.Tensor:
        """x -> the direct-distortion decoder's reconstruction."""
        return self.model.reconstruct(self._in(x))

    @torch.no_grad()
    def decode(self, z_hat) -> np.ndarray:
        """Decode latents through the direct-distortion decoder (host
        numpy out, as the JAX analyser returns)."""
        out = self.model.distortion_estimator.reconstruct(self._in(z_hat))
        return out.float().cpu().numpy()

    # -- plotting entry points ---------------------------------------------

    def codebook_plot(self, out_path, xlim=(-5, 5), ylim=(-5, 5), **kwargs):
        from .visualize import codebook_plot

        return codebook_plot(self.featurize, self.decode, out_path,
                             xlim=xlim, ylim=ylim, **kwargs)

    def maxinv_distribution_plot(self, out_path, n_samples: int = 20000):
        from .visualize import maxinv_distribution_plot

        ds = self.dataset
        samples = ds.data[:n_samples]
        return maxinv_distribution_plot(samples, ds.max_invariant, out_path)

    def reconstruction_plot(self, out_path, n: int = 8):
        from .visualize import plot_reconstructions

        x, _, _ = next(iter(self.dataset.batches(n, seed=0)))
        return plot_reconstructions(x, self.reconstruct(x), out_path, n=n)

    def latent_traversal_plot(self, out_dir, range_start: float = -5.0,
                              range_end: float = 5.0, n_per_lat: int = 7,
                              n_lat_traverse: int = 5):
        """1d and 2d latent traversals through the trained decoder. Writes
        traversals_1d.png and traversals_2d.png under `out_dir`."""
        from .visualize import latent_traversal_1d, latent_traversal_2d

        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        z_dim = self.cfg.encoder.z_dim
        p1 = latent_traversal_1d(
            self.decode, z_dim, out_dir / "traversals_1d.png",
            range_start=range_start, range_end=range_end,
            n_per_lat=n_per_lat, n_lat_traverse=n_lat_traverse)
        p2 = None
        if z_dim >= 2:
            p2 = latent_traversal_2d(
                self.decode, z_dim, out_dir / "traversals_2d.png",
                range_start=range_start, range_end=range_end,
                n_per_lat=n_per_lat)
        return p1, p2
