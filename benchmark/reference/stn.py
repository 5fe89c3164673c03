"""Spatial-transformer position estimator for layer placement.

Port of ``montage_gan_tpu/models/stn.py`` (the reference's STNv2c): a
(conv VALID → maxpool 2 → relu) × ``num_stages`` localization net over the
channel-stacked montage, an FC head regressing one translation per layer
(zero-initialised: an identity start), then a per-layer translate with
``pad_value=-1`` for [-1, 1] data.  The localization runs in NCHW
(``localization.*``, ``fc_loc.*`` are the reference checkpoint's names, with
the first FC over the C-major flatten).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .grid_sample import translate_sample, translate_to_theta
from .image_utils import stack_layer_to_channel

_KERNELS = (7, 5, 3, 3, 3)


def auto_stn_stages(img_resolution: int, max_stages: int = 5) -> int:
    """Deepest localization depth that keeps a ≥1px spatial output
    (the reference's fixed 5 stages assume 256px input)."""
    size = img_resolution
    stages = 0
    for k in _KERNELS[:max_stages]:
        nxt = (size - (k - 1)) // 2
        if nxt < 1:
            break
        size = nxt
        stages += 1
    return max(stages, 1)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: truncated normal in ±2σ with variance
    1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                          generator=generator)


class STN(nn.Module):
    def __init__(self, img_resolution: int = 256, img_channels: int = 4,
                 img_layers: int = 9, nf1: int = 64, nf2: int = 64,
                 num_stages: int = 5, pad_value: float = -1.0):
        super().__init__()
        self.img_channels = img_channels
        self.img_layers = img_layers
        self.pad_value = pad_value
        widths = (nf1, nf1 * 2, nf1 * 4, nf1 * 6, nf1 * 8)[:num_stages]
        mods = []
        cin, size = img_layers * img_channels, img_resolution
        for width, k in zip(widths, _KERNELS[:num_stages]):
            mods += [nn.Conv2d(cin, width, k), nn.MaxPool2d(2, 2), nn.ReLU()]
            cin, size = width, (size - (k - 1)) // 2
        self.localization = nn.Sequential(*mods)
        self.fc_loc = nn.Sequential(nn.Linear(cin * size * size, nf2),
                                    nn.ReLU(),
                                    nn.Linear(nf2, img_layers * 2))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.localization:
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)
        lecun_normal_(self.fc_loc[0].weight, self.fc_loc[0].in_features,
                      generator)
        nn.init.zeros_(self.fc_loc[0].bias)
        nn.init.zeros_(self.fc_loc[2].weight)
        nn.init.zeros_(self.fc_loc[2].bias)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x ``[B, L, H, W, C]`` in [-1, 1] → (translated ``[B, L, H, W, C]``,
        theta ``[B, L, 2, 3]``)."""
        b, l, h, w, c = x.shape
        assert l == self.img_layers and c == self.img_channels
        y = stack_layer_to_channel(x).permute(0, 3, 1, 2)  # NCHW view
        y = self.localization(y)
        translation = self.fc_loc(y.flatten(1)).reshape(b, l, 2)
        theta = translate_to_theta(translation)
        moved = translate_sample(x.reshape(b * l, h, w, c),
                                 translation.reshape(b * l, 2),
                                 pad_value=self.pad_value)
        return moved.reshape(b, l, h, w, c), theta
