"""The serving composition: z → (placed layers, montage).

Port of ``build_inference_fn`` (``montage_gan_tpu/utils/serving.py:38-78``):
mapping → per-layer synthesis → STN placement → clip → alpha composite.
The JAX package also exports this as StableHLO; that does not carry over.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .. import set_fp32_precision
from ..models.ensemble import MontageConfig, MontageEnsemble
from ..ops.composite import alpha_composite
from .image_utils import normalize_zero1


def build_inference_fn(cfg: MontageConfig, model: MontageEnsemble, *,
                       truncation_psi: float = 1.0,
                       noise_mode: str = 'const',
                       composite: str = 'alpha') -> Callable:
    """``fn(z, seed) → (placed, img)`` on the device of ``z``.

    ``placed``: ``[B, L, H, W, 4]`` per-layer RGBA in [-1, 1] after STN
    placement; ``img``: ``[B, H, W, 4]`` composited montage in [0, 1].
    ``seed`` seeds the synthesis noise when ``noise_mode='random'`` (a
    ``torch.Generator`` on z's device) and is ignored otherwise."""
    if composite != 'alpha':
        raise NotImplementedError(f'composite={composite!r}: only the alpha '
                                  'composite is ported yet')
    set_fp32_precision()

    def fn(z: torch.Tensor, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            generator = None
            if noise_mode == 'random':
                generator = torch.Generator(device=z.device)
                generator.manual_seed(int(seed))
            if cfg.train_global:
                placed, _ = model.run_global_g(
                    z, noise_mode=noise_mode, truncation_psi=truncation_psi,
                    generator=generator)
            else:
                ws = model.mapping(z, truncation_psi=truncation_psi)
                placed = model.synthesize_layers(ws, noise_mode=noise_mode,
                                                 generator=generator)
            placed = placed.clamp(-1, 1)
            return placed, alpha_composite(normalize_zero1(placed))

    return fn
