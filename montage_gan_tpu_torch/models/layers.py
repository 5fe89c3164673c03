"""Equalized-learning-rate layers shared by the networks.

Port of ``montage_gan_tpu/models/layers.py``.  Weights are stored in the
PyTorch layout (``[out, in]``, ``[out, in, kh, kw]``) under the reference
checkpoint's names, initialised N(0, 1)/lr_multiplier and scaled at run time
by lr_multiplier/sqrt(fan_in).  Activations are NHWC.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv2d_resample import conv2d_resample
from ..ops.filters import setup_filter


def normalize_2nd_moment(x: torch.Tensor, dim: int = -1,
                         eps: float = 1e-8) -> torch.Tensor:
    """RMS-normalize along ``dim``."""
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


class FullyConnected(nn.Module):
    """Equalized-LR linear layer; its bias and activation run in
    ``bias_act``."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, activation: str = 'linear',
                 lr_multiplier: float = 1.0, bias_init: float = 0.0):
        super().__init__()
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.bias_init = bias_init
        self.weight_gain = lr_multiplier / math.sqrt(in_features)
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features))
                     if use_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.normal_(self.weight, std=1.0 / self.lr_multiplier,
                        generator=generator)
        if self.bias is not None:
            nn.init.constant_(self.bias, self.bias_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = (self.weight * self.weight_gain).to(x.dtype)
        b = self.bias
        if b is not None and self.lr_multiplier != 1.0:
            b = b * self.lr_multiplier
        return bias_act(x @ w.t(), b, act=self.activation)


class Conv2dLayer(nn.Module):
    """Equalized-LR conv with optional FIR up/down resampling."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 use_bias: bool = True, activation: str = 'linear',
                 up: int = 1, down: int = 1,
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None):
        super().__init__()
        self.activation = activation
        self.up, self.down = up, down
        self.conv_clamp = conv_clamp
        self.padding = kernel_size // 2
        self.weight_gain = 1.0 / math.sqrt(in_channels * kernel_size ** 2)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if use_bias else None
        self.register_buffer('resample_filter',
                             setup_filter(list(resample_filter)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.normal_(self.weight, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        w = (self.weight * self.weight_gain).to(x.dtype)
        x = conv2d_resample(x, w, f=self.resample_filter, up=self.up,
                            down=self.down, padding=self.padding,
                            flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain,
                        clamp=act_clamp)
