"""Perceptual Path Length.

Port of ``montage_gan_tpu/metrics/perceptual_path_length.py`` (reference:
metrics/perceptual_path_length.py:24-135): pairs of latents interpolated
by slerp in Z (or lerp in W), perturbed by ε around a random
(``sampling='full'``) or zero (``'end'``) t, both ends synthesized, the
squared perceptual distance scaled by 1/ε², and the mean over the samples
between the 1st (``method='lower'``) and 99th (``'higher'``) percentiles.

W-space interpolation needs the generator split into ``map_fn(z) → ws``
and ``synth_fn(ws) → image`` (``[B, H, W, C]`` in [0, 1] on the device).
The distance is the extractor's (VGG16-LPIPS where its weights are found;
``metric_main``): its features are compared on the device, and only the
distances reach the host.  Batch ``k``'s ``z0``, ``z1`` and ``t`` come from
``metric_utils.ppl_draws`` (or an injected ``draw_fn(k, n)``); with ranks,
rank ``r`` takes the batches ``k ≡ r (mod R)`` and the distances are
gathered in batch order.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from . import metric_utils


def slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation returning a unit vector, as the reference
    (perceptual_path_length.py:24-33) and the JAX package do."""
    a_n = a / a.square().sum(dim=-1, keepdim=True).sqrt()
    b_n = b / b.square().sum(dim=-1, keepdim=True).sqrt()
    d = (a_n * b_n).sum(dim=-1, keepdim=True)
    p = t * torch.arccos(d.clamp(-1.0, 1.0))
    c = b_n - d * a_n
    c = c / c.square().sum(dim=-1, keepdim=True).sqrt()
    out = a_n * torch.cos(p) + c * torch.sin(p)
    return out / out.square().sum(dim=-1, keepdim=True).sqrt()


def lerp(w0: torch.Tensor, w1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-sample lerp of two mapped latents; ``t`` is ``[B, 1]``."""
    tt = t.reshape((t.shape[0],) + (1,) * (w0.ndim - 1))
    return w0 + (w1 - w0) * tt


def crop(img):
    """The reference's asymmetric face crop (perceptual_path_length.py:
    76-78): rows c*3 : c*7, cols c*2 : c*6 with c = H // 8."""
    c = img.shape[1] // 8
    return img[:, c * 3:c * 7, c * 2:c * 6]


def filtered_mean(dist: np.ndarray) -> float:
    """The mean of the distances within the [1, 99] percentiles
    (perceptual_path_length.py:128-131)."""
    lo = np.percentile(dist, 1, method='lower')
    hi = np.percentile(dist, 99, method='higher')
    return float(np.extract(np.logical_and(dist >= lo, dist <= hi),
                            dist).mean())


def compute_ppl_distances(sample_pair_fn: Optional[Callable] = None,
                          z_dim: int = 512, extractor=None,
                          num_samples: int = 50000, epsilon: float = 1e-4,
                          space: str = 'z', sampling: str = 'end',
                          crop_images: bool = False, batch_size: int = 8,
                          seed: int = 0,
                          map_fn: Optional[Callable] = None,
                          synth_fn: Optional[Callable] = None,
                          device='cuda',
                          draw_fn: Optional[Callable] = None) -> np.ndarray:
    """The ``num_samples`` scaled distances, float32, in batch order (see
    ``compute_ppl``)."""
    assert space in ('z', 'w') and sampling in ('full', 'end')
    if space == 'w' and (map_fn is None or synth_fn is None):
        raise ValueError(
            "w-space PPL requires map_fn and synth_fn (the mapping/synthesis "
            "split); refusing to silently fall back to z-space "
            "interpolation under a w-space metric name")
    if map_fn is None and sample_pair_fn is None:
        raise ValueError("provide map_fn+synth_fn or sample_pair_fn")
    dev = torch.device(device)
    if draw_fn is None:
        def draw_fn(k, n):
            return metric_utils.ppl_draws(seed, k, n, z_dim, sampling)

    @torch.no_grad()
    def batch(k):
        z0, z1, t = (torch.as_tensor(a, dtype=torch.float32).to(dev)
                     for a in draw_fn(k, batch_size))
        if space == 'w':
            w0, w1 = map_fn(z0), map_fn(z1)
            img0 = synth_fn(lerp(w0, w1, t))
            img1 = synth_fn(lerp(w0, w1, t + epsilon))
        else:
            zt0, zt1 = slerp(z0, z1, t), slerp(z0, z1, t + epsilon)
            if map_fn is not None:
                img0, img1 = synth_fn(map_fn(zt0)), synth_fn(map_fn(zt1))
            else:
                img0, img1 = sample_pair_fn(zt0, zt1)
        if crop_images:
            img0, img1 = crop(img0), crop(img1)
        f0 = extractor(img0[..., :3] * 255.0)
        f1 = extractor(img1[..., :3] * 255.0)
        return (f0 - f1).square().sum(dim=-1) / (epsilon ** 2)

    num_batches = math.ceil(num_samples / batch_size)
    dists = [d.cpu() for d in metric_utils.gather_in_order(
        num_batches, batch, metric_utils.data_parallel(dev))]
    return torch.cat(dists).numpy()[:num_samples]


def compute_ppl(sample_pair_fn: Optional[Callable] = None, z_dim: int = 512,
                extractor=None, num_samples: int = 50000,
                epsilon: float = 1e-4, space: str = 'z',
                sampling: str = 'end', crop: bool = False,
                batch_size: int = 8, seed: int = 0,
                map_fn: Optional[Callable] = None,
                synth_fn: Optional[Callable] = None, device='cuda',
                draw_fn: Optional[Callable] = None) -> float:
    """Args:
        map_fn / synth_fn: the split generator, ``map_fn(z) → ws`` and
            ``synth_fn(ws) → img`` (NHWC [0, 1]); needed for space='w'.
        sample_pair_fn: ``(z0, z1) → (img0, img1)`` over the two perturbed
            ends, for space='z' without the split.
        space / sampling: 'z'|'w' × 'full'|'end' (the reference's variants
            ppl_{z,w}{full,end} and ppl2_wend).
        draw_fn: ``(k, batch_size) → (z0, z1, t)`` of batch ``k``
            (default ``metric_utils.ppl_draws``).
    """
    dists = compute_ppl_distances(
        sample_pair_fn, z_dim, extractor, num_samples, epsilon, space,
        sampling, crop, batch_size, seed, map_fn, synth_fn, device, draw_fn)
    return metric_utils.on_primary(lambda: filtered_mean(dists),
                                   metric_utils.data_parallel(device))
