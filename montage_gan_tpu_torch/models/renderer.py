"""Learned renderers: a layer stack → one blended image.

Port of ``montage_gan_tpu/models/renderer.py`` (the reference's Renderer,
RendererTanh and RendererSubPixelConv).  The reference's quirk stays: the
middle "blocks" are one module applied several times (``*[self.block] * 3``
shares its weights), so the tanh and sigmoid renderers have one distinct mid
conv.  The modules carry the reference checkpoint's names: ``block.0`` and
the ``cnn`` Sequential, where the shared block sits under each of its
positions (``montage_gan_tpu/utils/torch_export.py::renderer_state_dict``).
The layers are plain convolutions (cuDNN on the card), in NCHW inside, with
the layer-to-channel order ``l*C + c`` of ``stack_layer_to_channel``.
Weights initialise as flax's ``nn.Conv`` does: lecun normal, zero bias.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.image_utils import stack_layer_to_channel
from .stn import lecun_normal_


def _conv(cin: int, cout: int, stride: int = 1, padding: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=padding)


class _Renderer(nn.Module):
    """``cnn`` over the channel-stacked layers; ``forward`` maps
    ``[B, L, H, W, C]`` → ``[B, H, W, C_out]`` (NHWC)."""

    block: nn.Sequential
    cnn: nn.Sequential

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():      # a shared block is visited once
            if isinstance(m, nn.Conv2d):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = stack_layer_to_channel(x).permute(0, 3, 1, 2)
        return self.cnn(y).permute(0, 2, 3, 1)


class _SimpleRenderer(_Renderer):
    def __init__(self, out_act: nn.Module, img_resolution: int = 256,
                 img_channels: int = 4, img_layers: int = 9, nf: int = 64):
        super().__init__()
        self.block = nn.Sequential(_conv(nf, nf), nn.ReLU())
        self.cnn = nn.Sequential(
            _conv(img_layers * img_channels, nf), nn.ReLU(),
            self.block, self.block, self.block,
            _conv(nf, img_channels), out_act)
        self.reset_parameters()


class RendererSigmoid(_SimpleRenderer):
    """Output in [0, 1]."""

    def __init__(self, **kwargs):
        super().__init__(nn.Sigmoid(), **kwargs)


class RendererTanh(_SimpleRenderer):
    """Output in [-1, 1]: the one the ensemble trains by default."""

    def __init__(self, **kwargs):
        super().__init__(nn.Tanh(), **kwargs)


class RendererSubPixelConv(_Renderer):
    """PixelShuffle(6) variant: the 36 channels of 9 RGBA layers become a
    6× larger one-channel image, which two strided convs bring back."""

    def __init__(self, img_resolution: int = 256, img_channels: int = 4,
                 img_layers: int = 9, nf1: int = 8, nf2: int = 64):
        super().__init__()
        r = int(round((img_layers * img_channels) ** 0.5))
        if r * r != img_layers * img_channels or r != 6:
            raise ValueError('the sub-pixel renderer takes 9 RGBA layers')
        self.block = nn.Sequential(_conv(nf2, nf2), nn.ReLU())
        self.cnn = nn.Sequential(
            nn.PixelShuffle(r),
            _conv(1, nf1, stride=2), nn.ReLU(),
            _conv(nf1, nf2, stride=3, padding=0), nn.ReLU(),
            self.block, self.block,
            _conv(nf2, 4), nn.Tanh())
        self.reset_parameters()


def build_renderer(renderer_type: str, **kwargs) -> _Renderer:
    """The renderer of ``MontageConfig.renderer_type``."""
    types = {'sigmoid': RendererSigmoid, 'tanh': RendererTanh,
             'subpixel': RendererSubPixelConv}
    if renderer_type not in types:
        raise ValueError(f'unknown renderer type {renderer_type!r}')
    return types[renderer_type](**kwargs)
