"""Style-modulated convolution.

Port of ``montage_gan_tpu/ops/modulated_conv.py``: the scale-activations
form — the activations are scaled by the styles, convolved with the shared
weight, and scaled by the demodulation coefficients, computed directly from
(styles, weights) in float32 as one ``[N, I] × [I, O]`` product:

    dcoef[n, o] = rsqrt( Σ_i styles[n, i]² · Σ_k w[o, i, k]²  + 1e-8 )

Noise is added after demodulation.
"""

from __future__ import annotations

from typing import Optional

import torch

from .conv2d_resample import conv2d_resample


def modulated_conv2d(x: torch.Tensor, weight: torch.Tensor,
                     styles: torch.Tensor,
                     noise: Optional[torch.Tensor] = None, up: int = 1,
                     down: int = 1, padding: int = 0,
                     resample_filter: Optional[torch.Tensor] = None,
                     demodulate: bool = True,
                     flip_weight: bool = True) -> torch.Tensor:
    """Args:
        x: ``[N, H, W, I]``.
        weight: ``[O, I, kh, kw]``.
        styles: ``[N, I]`` modulation coefficients.
        noise: optional ``[N, Ho, Wo, 1]`` (or broadcastable) additive noise.
    Returns:
        ``[N, Ho, Wo, O]``.
    """
    n = x.shape[0]
    in_channels = weight.shape[1]
    assert x.shape[-1] == in_channels
    assert styles.shape == (n, in_channels)

    x = x * styles.to(x.dtype)[:, None, None, :]
    x = conv2d_resample(x, weight, f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight)

    if demodulate:
        w32 = weight.float()
        w_sq = (w32 * w32).sum(dim=(2, 3))                       # [O, I]
        s32 = styles.float()
        var = (s32 * s32) @ w_sq.t()                             # [N, O]
        dcoefs = torch.rsqrt(var + 1e-8).to(x.dtype)
        x = x * dcoefs[:, None, None, :]
        if noise is not None:
            x = x + noise.to(x.dtype)
    elif noise is not None:
        x = x + noise.to(x.dtype)
    return x
