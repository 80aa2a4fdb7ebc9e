"""Training and post-hoc visualizations: codebook cells, latent
traversals, reconstructions, max-invariant distributions, dataset samples.

Counterpart of `lossyless_tpu/analysis/visualize.py`: plotting functions
over numpy arrays and callables (a trained compressor's encode and decode,
`analysis/pretrained.py::PretrainedAnalyser`). A callable may return a
tensor on any device; the functions move what they plot to the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """`a` as a numpy array on the host (a tensor from any device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_reconstructions(x, x_hat, out_path, n: int = 8):
    """Side-by-side originals / reconstructions (callbacks.py:92-116)."""
    plt = _plt()
    x, x_hat = _host(x)[:n], _host(x_hat)[:n]
    fig, axes = plt.subplots(2, n, figsize=(1.6 * n, 3.4))
    for i in range(n):
        for r, img in enumerate((x[i], x_hat[i])):
            ax = axes[r, i]
            ax.imshow(np.clip(img.squeeze(), 0, 1),
                      cmap="gray" if img.shape[-1] == 1 else None)
            ax.axis("off")
    axes[0, 0].set_title("x", loc="left")
    axes[1, 0].set_title("x_hat", loc="left")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def latent_traversal_1d(decode_fn, z_dim: int, out_path,
                        range_start: float = -5.0, range_end: float = 5.0,
                        n_per_lat: int = 7, n_lat_traverse: int = 5,
                        z_base=None):
    """Traverse the first `n_lat_traverse` latents SEPARATELY
    (LatentDimInterpolator.latent_traverse_1d, callbacks.py:172-231).

    Each traversed latent is SET to `n_per_lat` values linearly spanning
    [range_start, range_end] while the others stay at `z_base` (zeros by
    default, matching the reference). Image decoders produce a row-per-
    latent grid labeled "Lat. i"; 2-d point decoders (banana) get one panel
    per latent with the decoded sweep drawn as a colored path in source
    space.
    """
    plt = _plt()
    n_lat = min(n_lat_traverse, z_dim)
    sweeps = np.linspace(range_start, range_end, n_per_lat)
    base = (np.zeros(z_dim, np.float32) if z_base is None
            else _host(z_base).astype(np.float32))
    zs = np.tile(base, (n_lat * n_per_lat, 1))
    for i in range(n_lat):
        zs[i * n_per_lat:(i + 1) * n_per_lat, i] = sweeps
    out = _host(decode_fn(zs.astype(np.float32)))

    if out.ndim == 4:  # image decoder
        fig, axes = plt.subplots(n_lat, n_per_lat,
                                 figsize=(1.3 * n_per_lat, 1.4 * n_lat),
                                 squeeze=False)
        for r in range(n_lat):
            for c in range(n_per_lat):
                ax = axes[r, c]
                img = out[r * n_per_lat + c]
                ax.imshow(np.clip(img.squeeze(), 0, 1),
                          cmap="gray" if img.shape[-1] == 1 else None)
                ax.set_xticks([]); ax.set_yticks([])
                if c == 0:
                    ax.set_ylabel(f"Lat. {r}", fontsize=9)
                if r == 0:
                    ax.set_title(f"{sweeps[c]:.1f}", fontsize=8)
        fig.suptitle("Sweeps", fontsize=10)
    else:  # low-dim point decoder (banana): decoded path per latent
        fig, axes = plt.subplots(1, n_lat, figsize=(3.0 * n_lat, 3.0),
                                 squeeze=False)
        for r in range(n_lat):
            ax = axes[0, r]
            pts = out[r * n_per_lat:(r + 1) * n_per_lat]
            sc = ax.scatter(pts[:, 0], pts[:, 1], c=sweeps, cmap="viridis",
                            s=28, zorder=3)
            ax.plot(pts[:, 0], pts[:, 1], color="gray", lw=1, zorder=2)
            ax.set_title(f"Lat. {r}", fontsize=10)
        fig.colorbar(sc, ax=axes[0, -1], label="latent value")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def latent_traversal_2d(decode_fn, z_dim: int, out_path,
                        range_start: float = -5.0, range_end: float = 5.0,
                        n_per_lat: int = 7, z_base=None):
    """Traverse the first TWO latents together on a grid
    (LatentDimInterpolator.latent_traverse_2d, callbacks.py:196-217).

    Image decoders produce the n x n image grid with "1st/2nd Latent" axis
    labels; 2-d point decoders get the decoded deformation of the latent
    grid (rows/columns of the grid drawn as lines in source space).
    """
    plt = _plt()
    if z_dim < 2:
        raise ValueError("2d traversal needs z_dim >= 2")
    sweeps = np.linspace(range_start, range_end, n_per_lat)
    base = (np.zeros(z_dim, np.float32) if z_base is None
            else _host(z_base).astype(np.float32))
    zs = np.tile(base, (n_per_lat * n_per_lat, 1))
    g0, g1 = np.meshgrid(sweeps, sweeps, indexing="ij")
    zs[:, 0] = g0.ravel()  # rows: 1st latent
    zs[:, 1] = g1.ravel()  # cols: 2nd latent
    out = _host(decode_fn(zs.astype(np.float32)))

    if out.ndim == 4:  # image decoder
        fig, axes = plt.subplots(n_per_lat, n_per_lat,
                                 figsize=(1.2 * n_per_lat, 1.3 * n_per_lat),
                                 squeeze=False)
        for i in range(n_per_lat):
            for j in range(n_per_lat):
                ax = axes[i, j]
                img = out[i * n_per_lat + j]
                ax.imshow(np.clip(img.squeeze(), 0, 1),
                          cmap="gray" if img.shape[-1] == 1 else None)
                ax.set_xticks([]); ax.set_yticks([])
                if j == 0:
                    ax.set_ylabel(f"{sweeps[i]:.1f}", fontsize=8)
                if i == n_per_lat - 1:
                    ax.set_xlabel(f"{sweeps[j]:.1f}", fontsize=8)
        fig.supylabel("1st Latent", fontsize=10)
        fig.supxlabel("2nd Latent", fontsize=10)
    else:  # point decoder: decoded grid deformation
        pts = out.reshape(n_per_lat, n_per_lat, -1)
        fig, ax = plt.subplots(figsize=(5, 5))
        for i in range(n_per_lat):
            ax.plot(pts[i, :, 0], pts[i, :, 1], color="tab:blue", lw=1,
                    alpha=0.7)
            ax.plot(pts[:, i, 0], pts[:, i, 1], color="tab:orange", lw=1,
                    alpha=0.7)
        ax.scatter(pts[..., 0].ravel(), pts[..., 1].ravel(), s=10, c="k",
                   zorder=3)
        ax.set_title("decoded (lat0, lat1) grid")
        ax.set_xlabel("Source dim. 1")
        ax.set_ylabel("Source dim. 2")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def codebook_plot(encode_quantize_fn, decode_fn, out_path, xlim=(-5, 5),
                  ylim=(-5, 5), n_grid: int = 300):
    """Quantization cells + codebook of a 2D source (callbacks.py:234-362).

    `encode_quantize_fn`: (N,2) points -> (N, z_dim) *quantized* latents;
    `decode_fn`: latents -> (N,2) reconstructions (or None to skip points).
    """
    plt = _plt()
    xs = np.linspace(*xlim, n_grid)
    ys = np.linspace(*ylim, n_grid)
    grid = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.float32)

    z_hat = _host(encode_quantize_fn(grid))
    # discrete cell id per grid point
    _, cell_ids = np.unique(z_hat.round(5), axis=0, return_inverse=True)
    img = cell_ids.reshape(n_grid, n_grid)

    fig, ax = plt.subplots(figsize=(5.5, 5))
    # randomize color order so adjacent cells contrast
    rng = np.random.default_rng(0)
    perm = rng.permutation(cell_ids.max() + 1)
    ax.imshow(perm[img], origin="lower", extent=(*xlim, *ylim),
              cmap="tab20", interpolation="nearest", alpha=0.6)

    if decode_fn is not None:
        uniq = np.unique(z_hat.round(5), axis=0)
        points = _host(decode_fn(uniq.astype(np.float32)))
        ax.scatter(points[:, 0], points[:, 1], c="k", s=12, marker="o",
                   label="codebook")
        ax.legend(loc="upper right")
    # cells far outside the data manifold can decode to extreme points;
    # keep the view on the plotted source region (reference plots the
    # codebook over the quantization-cell image, callbacks.py:322-336)
    ax.set_xlim(*xlim)
    ax.set_ylim(*ylim)
    ax.set_xlabel("Source dim. 1")
    ax.set_ylabel("Source dim. 2")
    ax.set_title(f"{len(np.unique(cell_ids))} quantization cells")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def maxinv_distribution_plot(samples, max_invariant_fn, out_path,
                             n_bins: int = 60):
    """Histogram of the max-invariant under the source (callbacks.py:365-500)."""
    plt = _plt()
    samples = _host(samples)
    mx = _host(max_invariant_fn(samples)).ravel()
    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(9, 4))
    ax0.scatter(samples[:, 0], samples[:, 1], s=2, alpha=0.3)
    ax0.set_title("source samples")
    ax1.hist(mx, bins=n_bins, density=True)
    ax1.set_title("max-invariant M(X) distribution")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_dataset_samples(dataset, out_path, n: int = 4, nrow: int = 2,
                         seed: int = 123, pad: int = 2,
                         pad_value: float = 1.0, title: str | None = None):
    """Image grid of `n` dataset samples (utils/visualizations/images.py:14-31).

    Accepts an (N, H, W, C) array or any dataset exposing the repo's
    `.batches()` contract; `nrow` is images per grid row (the reference's
    torchvision.make_grid convention), `pad_value` fills the gutters.
    """
    plt = _plt()
    if hasattr(dataset, "batches"):
        # cap at the dataset size: batches() drops ragged tails by default,
        # so asking for more than len(dataset) would yield nothing
        n = max(1, min(n, len(dataset)))
        x = next(iter(dataset.batches(n, n_epochs=1, seed=seed)))[0]
        imgs = _host(x)[:n]
    else:
        arr = _host(dataset)
        rng = np.random.default_rng(seed)
        imgs = arr[rng.integers(0, len(arr), n)]
    imgs = imgs.astype(np.float32)
    k, H, W, C = imgs.shape
    ncols = max(1, nrow)
    nrows = -(-k // ncols)
    grid = np.full((nrows * (H + pad) + pad, ncols * (W + pad) + pad, C),
                   pad_value, np.float32)
    for i, im in enumerate(imgs):
        r, c = divmod(i, ncols)
        grid[pad + r * (H + pad):pad + r * (H + pad) + H,
             pad + c * (W + pad):pad + c * (W + pad) + W] = im
    fig, ax = plt.subplots(figsize=(2.2 * ncols, 2.2 * nrows))
    ax.imshow(np.clip(grid.squeeze(), 0, 1),
              cmap="gray" if C == 1 else None)
    ax.axis("off")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
