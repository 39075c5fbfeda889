"""Image logging helpers for the trainer's TensorBoard panels (numpy;
matplotlib only for the densify scatter, and only when installed).

- `easy_cmap`: a piecewise depth colormap, channel-last.
- `make_image_grid`: assembles the [pred | gt | depth | counts | error]
  debug panel.
"""

from __future__ import annotations

import numpy as np


def easy_cmap(x: np.ndarray) -> np.ndarray:
    """Depth (H, W) -> rgb (H, W, 3) in [0, 1]."""
    x = np.asarray(x)
    r = np.clip(x, 0, 10) / 10.0
    g = np.clip(x - 10, 0, 50) / 50.0
    b = np.clip(x - 60, 0, 200) / 200.0
    return 1.0 - np.stack([r, g, b], axis=-1)


def normalized_gray(x: np.ndarray) -> np.ndarray:
    """Scalar map (H, W) -> rgb by max-normalization."""
    x = np.asarray(x, np.float32)
    denom = max(float(x.max()), 1e-12)
    v = x / denom
    return np.repeat(v[:, :, None], 3, axis=2)


def make_image_grid(images, nrow: int = 2, pad: int = 2,
                    pad_value: float = 0.5) -> np.ndarray:
    """Stack (H, W, 3) images into a grid, `nrow` images per row."""
    images = [np.clip(np.asarray(im, np.float32), 0.0, 1.0) for im in images]
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    cols = nrow
    rows = (len(images) + cols - 1) // cols
    grid = np.full((rows * (h + pad) + pad, cols * (w + pad) + pad, 3),
                   pad_value, np.float32)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        y = pad + r * (h + pad)
        x = pad + c * (w + pad)
        grid[y:y + im.shape[0], x:x + im.shape[1]] = im
    return grid


def densify_scatter_figure(point_uv: np.ndarray, floater_mask: np.ndarray,
                           over_mask: np.ndarray, under_mask: np.ndarray,
                           height: int, width: int):
    """Floater (blue) / over-reconstructed (red) / under-reconstructed
    (green) scatter in image space, the densification debug figure.
    Returns an (H, W, 3) float image in [0, 1], or None if matplotlib is
    not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots(figsize=(6, 6 * height / max(width, 1)), dpi=100)
    for mask, color, label, zorder in (
            (floater_mask, "b", "floater", 2),
            (over_mask, "r", "over_reconstructed", 3),
            (under_mask, "g", "under_reconstructed", 4)):
        uv = point_uv[np.asarray(mask, bool)]
        ax.scatter(uv[:, 0], uv[:, 1], s=1, c=color, label=label,
                   zorder=zorder)
    ax.legend(loc="upper right", fontsize=7)
    ax.set_xlim([0, width])
    ax.set_ylim([height, 0])
    fig.tight_layout()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[:, :, :3] / 255.0
    plt.close(fig)
    return img.astype(np.float32)
