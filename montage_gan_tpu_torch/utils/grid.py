"""Image grids of the training loop's snapshots (port of
``montage_gan_tpu/utils/grid.py``; the torchvision.utils.save_image role in
the reference's snapshot code, custom/training_loop_aio.py:750-777),
written by the port's PNG writer."""

from __future__ import annotations

import numpy as np

from .png import write_png


def to_uint8(img: np.ndarray, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    img = (np.asarray(img, np.float32) - lo) / (hi - lo)
    return (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """[N, H, W, C] → one [GH, GW, C] grid image."""
    n, h, w, c = images.shape
    ncol = nrow
    nrows = (n + ncol - 1) // ncol
    grid = np.full((nrows * (h + pad) + pad, ncol * (w + pad) + pad, c),
                   pad_value, dtype=images.dtype)
    for i in range(n):
        r, col = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def save_image_grid(images: np.ndarray, path: str, nrow: int = 8,
                    lo: float = 0.0, hi: float = 1.0) -> None:
    """[N, H, W, C] (C = 1, 3 or 4; uint8, or float in [lo, hi]) → a PNG
    grid of ``nrow`` columns."""
    if images.dtype == np.uint8:
        grid = to_uint8(make_grid(images, nrow=nrow), 0, 255)
    else:
        grid = to_uint8(make_grid(images, nrow=nrow), lo, hi)
    write_png(path, grid)
