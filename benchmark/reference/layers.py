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

from .bias_act import activation_funcs, bias_act
from .conv2d_resample import conv2d_resample
from .filters import setup_filter
from . import mesh


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
                 conv_clamp: Optional[float] = None, trainable: bool = True):
        super().__init__()
        self.activation = activation
        self.up, self.down = up, down
        self.conv_clamp = conv_clamp
        self.trainable = trainable   # False: no gradient reaches the weights

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
        weight, bias = self.weight, self.bias
        if not self.trainable:        # Freeze-D: JAX's stop_gradient
            weight = weight.detach()
            bias = bias.detach() if bias is not None else None
        w = (weight * self.weight_gain).to(x.dtype)
        x = conv2d_resample(x, w, f=self.resample_filter, up=self.up,
                            down=self.down, padding=self.padding,
                            flip_weight=(self.up == 1))
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, bias, act=self.activation, gain=act_gain,
                        clamp=act_clamp)


class MinibatchStd(nn.Module):
    """Minibatch standard-deviation feature channel
    (``montage_gan_tpu/models/layers.py:97-118``).  Groups are strided over
    the batch axis: sample ``n`` is in group ``n % (N / G)``.  Under data
    parallelism ``N`` is the global batch (as in the JAX package's step over
    its mesh): the ranks' inputs are gathered, with gradient, and each rank
    keeps its rows."""

    def __init__(self, group_size: Optional[int] = 4, num_channels: int = 1):
        super().__init__()
        self.group_size = group_size
        self.num_channels = num_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs, first = mesh.gather_batch(x)
        n, h, w, c = xs.shape
        g = min(self.group_size, n) if self.group_size is not None else n
        if n % g != 0:
            raise ValueError(f'batch {n} not divisible by mbstd group {g}')
        f = self.num_channels
        y = xs.float().reshape(g, -1, h, w, f, c // f)
        y = y - y.mean(dim=0, keepdim=True)
        y = y.square().mean(dim=0)                     # [n/g, h, w, f, cc]
        y = (y + 1e-8).sqrt()
        y = y.mean(dim=(1, 2, 4))                      # [n/g, f]
        y = y.reshape(1, -1, 1, 1, f).repeat(g, 1, h, w, 1).reshape(n, h, w, f)
        if n != x.shape[0]:
            y = y[first:first + x.shape[0]]
        return torch.cat([x, y.to(x.dtype)], dim=-1)
