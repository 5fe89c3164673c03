"""Synthetic multi-layer RGBA data.

The port's own copy of ``montage_gan_tpu/data/synthetic.py`` (the
reference's training data is withheld): each of the 9 named layers is an
anti-aliased coloured ellipse at that layer's canonical position, drawn with
numpy from a ``RandomState``, so both packages give the same pixels for the
same seed.  ``make_synthetic_layer_dataset`` writes them as layer PNGs in the
directory-of-directories layout ``DatasetAIO`` reads, through the port's PNG
writer.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..utils.png import write_png_rgba

# (name, center_xy, radius_xy) loosely following the reference layer geometry
DEFAULT_SPEC = (
    ('#1_hair_back', (128, 110), (90, 100)),
    ('#2_body', (128, 190), (80, 60)),
    ('#2_ear', (128, 130), (95, 60)),
    ('#3_face', (128, 100), (70, 80)),
    ('#4_eye', (128, 108), (55, 30)),
    ('#4_mouth', (128, 155), (25, 15)),
    ('#4_nose', (128, 133), (8, 15)),
    ('#5_hair_front', (128, 85), (80, 60)),
    ('#6_brow', (128, 85), (50, 12)),
)


def _ellipse_layer(size: int, center, radius, color, rng) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cx = center[0] + rng.uniform(-8, 8)
    cy = center[1] + rng.uniform(-8, 8)
    rx = max(radius[0] * rng.uniform(0.7, 1.0), 3)
    ry = max(radius[1] * rng.uniform(0.7, 1.0), 3)
    d = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
    alpha = np.clip((1.0 - d) * 4.0, 0.0, 1.0)
    img = np.zeros((size, size, 4), np.float32)
    img[..., :3] = np.asarray(color, np.float32)
    img[..., 3] = alpha
    return img


def make_synthetic_layer_dataset(path: str, num_samples: int = 16,
                                 size: int = 256,
                                 spec: Sequence = DEFAULT_SPEC,
                                 seed: int = 0) -> str:
    """Write a synthetic dataset to ``path`` and return it."""
    rng = np.random.RandomState(seed)
    scale = size / 256.0
    os.makedirs(path, exist_ok=True)
    for n in range(num_samples):
        d = os.path.join(path, f"{n:05d}")
        os.makedirs(d, exist_ok=True)
        for name, center, radius in spec:
            color = rng.uniform(0.1, 1.0, size=3)
            img = _ellipse_layer(
                size, (center[0] * scale, center[1] * scale),
                (max(radius[0] * scale, 3), max(radius[1] * scale, 3)),
                color, rng)
            write_png_rgba(os.path.join(d, f"{name}.png"),
                           (img * 255).astype(np.uint8))
    return path


def synthetic_batch(rng: np.random.RandomState, batch: int,
                    num_layers: int = 9, size: int = 256) -> np.ndarray:
    """In-memory synthetic batch ``[B, L, size, size, 4]`` in [0, 1]."""
    out = np.zeros((batch, num_layers, size, size, 4), np.float32)
    spec = list(DEFAULT_SPEC)[:num_layers]
    scale = size / 256.0
    for b in range(batch):
        for l, (_, center, radius) in enumerate(spec):
            color = rng.uniform(0.1, 1.0, size=3)
            out[b, l] = _ellipse_layer(
                size, (center[0] * scale, center[1] * scale),
                (max(radius[0] * scale, 3), max(radius[1] * scale, 3)),
                color, rng)
    return out
