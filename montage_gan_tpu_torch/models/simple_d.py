"""Simple global discriminators for stage-0 STN pretraining.

Port of ``montage_gan_tpu/models/simple_d.py`` (the reference's
SimpleGlobalDiscriminator, fukuwarai/networks.py:286-326, and
SimpleGlobalDiscriminatorV2, :340-417).  ``cli/pretrain_stn.py`` alone uses
them.  No exporter names their parameters, so the submodules carry the JAX
package's flax names (``Conv_0``, ``ResidualBlock_0``, ``Dense_0``, ...;
``utils/weights.py::simple_d_state_dict`` converts its variables).  Images
are NHWC as for ``Discriminator``; the layers run in NCHW, and each Dense
reads the HWC-major flatten, as flax's does.  Weights initialise as flax's
``nn.Conv``/``nn.Dense``: lecun normal, zero bias.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .stn import lecun_normal_


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW → the ``[N, H*W*C]`` flatten flax's Dense reads."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _Flax(nn.Module):
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun_normal_(m.weight, m.weight[0].numel(), generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)


class ResidualBlock(_Flax):
    """Two 3×3 convs with leaky ReLU 0.2, plus the input (through a 1×1
    conv where the widths differ) (``simple_d.py:18-35``)."""

    def __init__(self, inplanes: int, planes: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(inplanes, planes, 3, padding=1)
        self.Conv_1 = nn.Conv2d(planes, planes, 3, padding=1)
        self.Conv_2 = (nn.Conv2d(inplanes, planes, 1)
                       if inplanes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _lrelu(self.Conv_1(_lrelu(self.Conv_0(x))))
        return y + (self.Conv_2(x) if self.Conv_2 is not None else x)


class SimpleGlobalDiscriminator(_Flax):
    """img ``[B, H, W, C]`` → logits ``[B, 1]``: a 3×3 conv, six residual
    blocks each followed by AvgPool(3, 2, 1) counting the padding, and one
    Dense (``simple_d.py:38-54``)."""

    def __init__(self, img_resolution: int = 256, img_channels: int = 4,
                 nf1: int = 64):
        super().__init__()
        widths = (nf1, nf1 * 2, nf1 * 4, nf1 * 8, nf1 * 16, nf1 * 16)
        self.Conv_0 = nn.Conv2d(img_channels, nf1, 3, padding=1)
        cin, size = nf1, img_resolution
        for i, w in enumerate(widths):
            setattr(self, f'ResidualBlock_{i}', ResidualBlock(cin, w))
            cin, size = w, (size - 1) // 2 + 1
        self.num_blocks = len(widths)
        self.Dense_0 = nn.Linear(cin * size * size, 1)
        self.reset_parameters()

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        y = self.Conv_0(img.permute(0, 3, 1, 2).float())
        for i in range(self.num_blocks):
            y = getattr(self, f'ResidualBlock_{i}')(y)
            y = F.avg_pool2d(y, 3, stride=2, padding=1, count_include_pad=True)
        return self.Dense_0(_flatten_hwc(y))


def bilinear_down2(x: torch.Tensor) -> torch.Tensor:
    """NCHW → half size, as ``jax.image.resize(..., 'bilinear')`` shrinks:
    the triangle filter widened by 2 (taps 1, 3, 3, 1 over 8), its weights
    renormalised where they fall off the edge (``simple_d.py:57-61``)."""
    return F.interpolate(x, size=(x.shape[2] // 2, x.shape[3] // 2),
                         mode='bilinear', align_corners=False, antialias=True)


class SimpleDiscriminatorBlock(_Flax):
    """(``simple_d.py:64-77``) The first block maps the image to
    ``tmp_planes`` by a 1×1 conv; then a 1×1 skip to ``planes`` (no bias)
    and two 3×3 convs, each path halved bilinearly."""

    def __init__(self, inplanes: int, tmp_planes: int, planes: int,
                 first: bool = False):
        super().__init__()
        self.first = first
        convs = []
        if first:
            convs.append(nn.Conv2d(inplanes, tmp_planes, 1))
            inplanes = tmp_planes
        convs += [nn.Conv2d(inplanes, planes, 1, bias=False),
                  nn.Conv2d(inplanes, tmp_planes, 3, padding=1),
                  nn.Conv2d(tmp_planes, planes, 3, padding=1)]
        for i, conv in enumerate(convs):
            setattr(self, f'Conv_{i}', conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        i = 0
        if self.first:
            x = _lrelu(self.Conv_0(x))
            i = 1
        skip, conv_a, conv_b = (getattr(self, f'Conv_{i + k}')
                                for k in range(3))
        y = bilinear_down2(skip(x))
        x = _lrelu(conv_a(x))
        x = _lrelu(bilinear_down2(conv_b(x)))
        return y + x


class SimpleGlobalDiscriminatorV2(_Flax):
    """img ``[B, H, W, C]`` → logits ``[B, 1]``: six bilinear-halving
    blocks, then Dense(nf) and Dense(1) (``simple_d.py:80-95``)."""

    SPECS = ((128, 256, True), (256, 512, False), (512, 512, False),
             (512, 512, False), (512, 512, False), (512, 512, False))

    def __init__(self, img_resolution: int = 256, img_channels: int = 4,
                 nf: int = 512):
        super().__init__()
        cin, size = img_channels, img_resolution
        for i, (tmp, out, first) in enumerate(self.SPECS):
            setattr(self, f'SimpleDiscriminatorBlock_{i}',
                    SimpleDiscriminatorBlock(cin, tmp, out, first=first))
            cin, size = out, size // 2
        if size < 1:
            raise ValueError(f'SimpleGlobalDiscriminatorV2 halves its input '
                             f'{len(self.SPECS)} times: resolution '
                             f'{img_resolution} is too small')
        self.Dense_0 = nn.Linear(cin * size * size, nf)
        self.Dense_1 = nn.Linear(nf, 1)
        self.reset_parameters()

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        y = img.permute(0, 3, 1, 2).float()
        for i in range(len(self.SPECS)):
            y = getattr(self, f'SimpleDiscriminatorBlock_{i}')(y)
        return self.Dense_1(self.Dense_0(_flatten_hwc(y)))
