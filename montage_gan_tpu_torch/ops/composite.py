"""Alpha compositing of RGBA layer stacks.

Port of ``montage_gan_tpu/ops/composite.py``: the straight-alpha A-over-B
recurrence (layer l over the canvas of layers < l) in closed form, with an
exclusive reverse cumulative product of transmittances —

    A_out           = 1 - Π_l (1 - a_l)
    C_out · A_out   = Σ_l c_l · a_l · Π_{k>l} (1 - a_k)

and 0/0 colour divisions resolving to 0.
"""

from __future__ import annotations

import torch

from .grid_sample import translate_sample


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den with 0/0 → 0."""
    den_safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(num), num / den_safe)


def alpha_composite(layers: torch.Tensor, layer_axis: int = 1) -> torch.Tensor:
    """Straight-alpha composite over the layer axis of ``[..., L, H, W, 4]``
    RGBA in [0, 1] (higher ``l`` on top); returns the layer axis removed."""
    layers = torch.movedim(layers, layer_axis, 0)               # [L, ..., 4]
    color = layers[..., :3]
    alpha = layers[..., 3:4]

    # transmittance above layer l: T_l = Π_{k>l} (1 - a_k) (exclusive, reversed)
    one_minus = 1.0 - alpha
    rev = torch.flip(one_minus, [0])
    t_above = torch.flip(
        torch.cat([torch.ones_like(rev[:1]), torch.cumprod(rev, 0)[:-1]], 0),
        [0])

    weight = alpha * t_above
    alpha_out = 1.0 - torch.prod(one_minus, 0)
    color_out = _safe_div(torch.sum(color * weight, 0), alpha_out)
    return torch.cat([color_out, alpha_out], -1)


def translate_and_composite(layers: torch.Tensor, translations: torch.Tensor,
                            pad_value: float = 0.0,
                            input_range: str = 'zero1') -> torch.Tensor:
    """Per-layer translation + alpha composite of ``[B, L, H, W, 4]`` by
    ``[B, L, 2]`` normalized (dx, dy): the plain version of the TPU
    composite kernel (``ops/pallas/composite_kernel.py``), whose port comes
    in a later slice."""
    b, l, h, w, c = layers.shape
    moved = translate_sample(layers.reshape(b * l, h, w, c),
                             translations.reshape(b * l, 2),
                             pad_value=pad_value).reshape(b, l, h, w, c)
    if input_range == 'minus11':
        return alpha_composite((moved + 1.0) * 0.5) * 2.0 - 1.0
    return alpha_composite(moved)
