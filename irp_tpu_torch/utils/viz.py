"""Visualization: sample-image grids and the sweep's cross-fold curve.

Figures are written to files (Agg backend), so they work headless.  The
JAX package's other figures (confusion heatmap, training curves) come
over with the slices that call them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402


def plot_image_grid(images: Sequence[np.ndarray], titles: Sequence[str],
                    path: str, ncols: int = 5,
                    suptitle: Optional[str] = None) -> str:
    """uint8 HWC images in a grid with per-image titles."""
    n = len(images)
    if n == 0:
        return path
    ncols = min(ncols, n)
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(3 * ncols, 3.2 * nrows))
    axes = np.atleast_1d(axes).reshape(-1)
    for ax in axes[n:]:
        ax.axis("off")
    for ax, img, title in zip(axes, images, titles):
        ax.imshow(img.astype(np.uint8))
        ax.set_title(title, fontsize=9)
        ax.axis("off")
    if suptitle:
        fig.suptitle(suptitle)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return path


def plot_epoch_mean_std(epochs: Sequence[int], means: Sequence[float],
                        stds: Sequence[float], path: str,
                        title: str = "Cross-fold validation accuracy"
                        ) -> str:
    """Mean accuracy per epoch with a +-std band."""
    means = np.asarray(means)
    stds = np.asarray(stds)
    plt.figure(figsize=(8, 5))
    plt.plot(epochs, means, marker="o")
    plt.fill_between(epochs, means - stds, means + stds, alpha=0.25)
    plt.xlabel("epoch")
    plt.ylabel("val acc (%)")
    plt.title(title)
    plt.tight_layout()
    plt.savefig(path)
    plt.close()
    return path
